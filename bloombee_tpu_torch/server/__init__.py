"""Span server of the port: `BlockServer` (block_server.py) over the
compute queue, the wire and the registry."""
