"""Models of the port: DIEN's serving path (``dien``)."""
