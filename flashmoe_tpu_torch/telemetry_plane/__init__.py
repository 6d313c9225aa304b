"""Host-side telemetry of the port: the streaming sketches the serving
engine keeps (the rest of the JAX package's live plane is not ported)."""
