"""Launchers of the port: the LLM FedSGD trainer (``train``), the server
(``serve``), their step builders, sharding rules and traffic model."""
