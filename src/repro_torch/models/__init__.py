"""Models of the port: DIEN (``dien``), the four GNNs (``gnn``) and the
five LMs (``transformer``)."""
