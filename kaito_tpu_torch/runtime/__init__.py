"""Runtime services around the serving engine: the SLO watchdog, the
routing data path with its two fronts (the endpoint picker and the
round-robin router), the health and self-benchmark probes, the hub
fetch, the HF transformers fallback runtime, and the fleet telemetry
plane the operator's manager scrapes replicas with."""
