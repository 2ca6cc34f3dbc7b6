#!/usr/bin/env python3
"""The JAX package's altair roots of chip_smoke.py's two altair recipes.

    JAX_PLATFORMS=cpu python3 scripts/torch_altair_reference_root.py [N_EPOCH [N_BLOCK]]

Builds `chip_smoke.altair_epoch_state` with N_EPOCH validators (default:
chip_smoke.N_VALIDATORS, 262,144) and `chip_smoke.altair_block_case` with
N_BLOCK validators (default: chip_smoke.N_ALTAIR_BLOCK, 8,192) in the
PyTorch port's containers, on the CPU, carries each into the JAX package's
`get_spec("altair", "mainnet")` as SSZ bytes, runs the reference's
`process_slots(state, 128)` on the first and `state_transition` with its
native BLS backend (every signature checked) on the second, and prints
both roots at slot 128, one a line, the epoch's first.  chip_smoke.py's
phases "altair epoch" and "altair block" hold the port's runs on the card
against them (POST_ALTAIR_EPOCH_ROOT_128, POST_ALTAIR_BLOCK_ROOT_128).
Memory: a few GiB at the default sizes, for the copies of the states.
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
    args = [int(a) for a in sys.argv[1:]]
    n_epoch = args[0] if args else chip_smoke.N_VALIDATORS
    n_block = args[1] if len(args) > 1 else chip_smoke.N_ALTAIR_BLOCK
    spec = get_spec("altair", "mainnet")

    t0 = time.perf_counter()
    epoch_data = chip_smoke.altair_epoch_state(spec, n_epoch).encode_bytes()
    gc.collect()
    print(f"altair epoch state of {n_epoch} validators built in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    state, signed, facts = chip_smoke.altair_block_case(spec, n_block)
    block_data, block = state.encode_bytes(), signed.encode_bytes()
    del state, signed, facts
    gc.collect()
    print(f"altair pre-state of {n_block} validators and its block built "
          f"in {time.perf_counter() - t0:.1f} s", flush=True)

    from consensus_specs_tpu.specs import get_spec as reference_spec
    from consensus_specs_tpu.utils import bls
    bls.use_native()
    bls.bls_active = True
    ref = reference_spec("altair", "mainnet")
    state = ref.BeaconState.decode_bytes(epoch_data)
    del epoch_data
    t0 = time.perf_counter()
    ref.process_slots(state, chip_smoke.EPOCH_SLOT + 1)
    epoch_root = bytes(ref.hash_tree_root(state)).hex()
    print(f"reference process_slots to {chip_smoke.EPOCH_SLOT + 1} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    del state
    gc.collect()
    state = ref.BeaconState.decode_bytes(block_data)
    t0 = time.perf_counter()
    ref.state_transition(state, ref.SignedBeaconBlock.decode_bytes(block))
    block_root = bytes(ref.hash_tree_root(state)).hex()
    print(f"reference state_transition to slot {chip_smoke.EPOCH_SLOT + 1} "
          f"in {time.perf_counter() - t0:.1f} s", flush=True)
    print(epoch_root)
    print(block_root)


if __name__ == "__main__":
    main()
