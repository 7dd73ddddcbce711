"""Cell factories of the port (``step.build_cell``)."""
