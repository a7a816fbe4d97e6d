"""Runtime services around the serving engine: the SLO watchdog, the
router's prefix hashes the KV pool publishes under, and the fleet
telemetry plane the operator's manager scrapes replicas with."""
