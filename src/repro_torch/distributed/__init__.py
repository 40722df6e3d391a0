"""Distributed pieces of the port: the trainer's ``StragglerMonitor``
(``elastic``).  Sketched collectives, sharding and elastic restore wait
for ROADMAP A13."""
