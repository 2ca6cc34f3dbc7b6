"""Distributed layer, width 1.

Counterpart of consensus_specs_tpu/parallel: only the verify path's
single-device surface of shard_verify.py is ported so far.  Meshes, the
sharded pairing product and the collectives come with the multi-device
slice (ROADMAP A10).
"""
