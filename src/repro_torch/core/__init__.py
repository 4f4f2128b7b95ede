"""Core of the port: key schedule, codec, channel, transport, aggregation."""
