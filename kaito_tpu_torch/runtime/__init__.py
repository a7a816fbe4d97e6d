"""Runtime services around the serving engine: the SLO watchdog and the
router's prefix hashes the KV pool publishes under."""
