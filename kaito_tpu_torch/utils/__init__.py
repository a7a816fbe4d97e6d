"""Host-side utilities of the port: request tracing, the step flight
recorder, the incident bundles, the Prometheus text parser and the named
fault-injection points."""
