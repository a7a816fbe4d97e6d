"""Runtime services around the serving engine: the SLO watchdog."""
