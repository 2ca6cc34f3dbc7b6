"""The host half of BLS12-381: a verbatim copy of consensus_specs_tpu/crypto's
pure-Python fields, curve, pairing, hash-to-curve and signature suite.

Point decoding with subgroup checks, hash-to-field, SSWU and the isogeny,
`Sign` and `SkToPk` run here on Python ints; the port's `"native"` BLS
backend is this suite, the oracle the device backend is held against.
"""
