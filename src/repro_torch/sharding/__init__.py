"""Parameter sharding rules (the port of ``repro.sharding.rules``)."""
