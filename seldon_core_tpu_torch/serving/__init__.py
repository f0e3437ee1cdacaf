"""Transport tier: the REST engine server."""
