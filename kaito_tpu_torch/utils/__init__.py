"""Host-side utilities of the port: request tracing, the step flight
recorder, the incident bundles and the Prometheus text parser."""
