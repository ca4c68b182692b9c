"""The web demo of the torch port: its game engine bridge and server."""
