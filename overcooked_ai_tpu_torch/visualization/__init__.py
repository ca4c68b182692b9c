"""State rendering of the torch port, on the host."""
