"""Agents and agent-pair evaluation of the torch port."""
