"""Core substrate of the port: process groups, meshes of processes,
collectives and the parameter-server partitioner (the port of
:mod:`pddl_tpu.core`).

The JAX package replaces the reference's native machinery (NCCL rings,
``SlurmClusterResolver``, ``hvd.init()``, gRPC clusters) with
``jax.distributed`` and one ``jax.sharding.Mesh``; the port puts the same
surface on ``torch.distributed``, one process per device, NCCL on the card
and gloo on the CPU.
"""
