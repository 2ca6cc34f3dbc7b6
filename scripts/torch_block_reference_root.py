#!/usr/bin/env python3
"""The JAX package's post-block root of chip_smoke.py's block recipe.

    JAX_PLATFORMS=cpu python3 scripts/torch_block_reference_root.py [N]

Builds `chip_smoke.block_case` (the PyTorch port's containers and keys,
seeded: the pre-state at slot 97 and a signed block at slot 98 with 8
full-committee attestations, a proposer and an attester slashing) with N
validators (default: chip_smoke.N_BLOCK_VALIDATORS, 16,384) on the CPU, carries
both into the JAX package as SSZ bytes, runs the reference's
`state_transition` with its native BLS backend (every signature checked)
and prints the post-state root.  chip_smoke.py's phase "block" holds the
port's run on the card against this root (POST_BLOCK_ROOT_98).  Memory: a
few GiB at the default size, for the copies of the state.
"""
import gc
import importlib.util
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main():
    spec_file = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    chip_smoke = importlib.util.module_from_spec(spec_file)
    spec_file.loader.exec_module(chip_smoke)
    import consensus_specs_tpu_torch as port
    from consensus_specs_tpu_torch.specs import get_spec
    from consensus_specs_tpu_torch.ssz import merkle
    port.set_device("cpu")
    merkle.use_host_hashing()
    n = (int(sys.argv[1]) if len(sys.argv) > 1
         else chip_smoke.N_BLOCK_VALIDATORS)

    t0 = time.perf_counter()
    state, signed, facts = chip_smoke.block_case(
        get_spec("phase0", "mainnet"), n)
    data, block = state.encode_bytes(), signed.encode_bytes()
    del state, signed
    gc.collect()
    print(f"pre-state of {n} validators and block of "
          f"{len(facts['committees'])} attestations built in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    from consensus_specs_tpu.specs import get_spec as reference_spec
    from consensus_specs_tpu.utils import bls
    bls.use_native()
    bls.bls_active = True
    spec = reference_spec("phase0", "mainnet")
    state = spec.BeaconState.decode_bytes(data)
    del data
    t0 = time.perf_counter()
    spec.state_transition(state, spec.SignedBeaconBlock.decode_bytes(block))
    root = bytes(spec.hash_tree_root(state)).hex()
    print(f"reference state_transition to slot {chip_smoke.BLOCK_SLOT} in "
          f"{time.perf_counter() - t0:.1f} s")
    print(root)


if __name__ == "__main__":
    main()
