"""Observability of the port: for now only the memory planner
(``obs.memory``).  The rest of the JAX package's ``obs/`` (traces, metric
registry, heartbeats, reports, cost records) comes with ROADMAP.md, A.13."""
