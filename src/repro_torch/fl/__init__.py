"""Federated learning over the simulated uplink: model, data split, engine."""
