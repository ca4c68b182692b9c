"""Command-line entry points of the torch port (each has `main(argv=None)`)."""
