"""The parallel layer of the port (the reference's ``src/repro/parallel``):
logical sharding rules and specs on a ``DeviceMesh`` (``sharding``), the
sharded parameters of a train step (``fsdp``), each rank's blocks of the
decode caches of a serving step (``kvcache``), the int8 error-feedback
collectives (``collectives``) and the GPipe schedule (``pipeline``)."""
