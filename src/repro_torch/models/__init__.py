"""Models of the port: the dense and moe decoder families
(``transformer``, with the expert FFN in ``moe``), their building blocks
and the family registry."""
