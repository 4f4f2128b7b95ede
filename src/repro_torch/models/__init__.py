"""Models of the port: the dense decoder family (``transformer``), its
building blocks and the family registry."""
