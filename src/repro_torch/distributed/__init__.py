"""Sharding rules and the activation-sharding context of the port."""
