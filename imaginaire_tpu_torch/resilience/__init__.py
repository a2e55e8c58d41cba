"""Fault tolerance (port of part of ``imaginaire_tpu/resilience/``): the
checkpoint integrity layer. Retries, chaos injection, the preemption
guard, cluster coordination and elastic pods are not in the port yet."""
