"""Planner tables of the torch port: numpy host precompute, looked up on the device."""
