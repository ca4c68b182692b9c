"""The plain reference of the benchmark: frozen copies of the port's plain
step, encoding, featurize and phi, and a learner written from the published
definitions. It imports nothing of the port."""
