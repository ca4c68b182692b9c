"""The single-env driver and the gymnasium adapter of the torch port."""
