"""Runtime pieces of the port (host-memory KV offload)."""
