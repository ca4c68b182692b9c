"""The harness: finding a cell's files by name, the card, its trace, seeds
and weights."""
