#!/usr/bin/env python3
"""The JAX package's post-epoch root of chip_smoke.py's epoch state.

    JAX_PLATFORMS=cpu python3 scripts/torch_epoch_reference_root.py [N]

Builds `chip_smoke.epoch_state` (the PyTorch port's containers, seeded) with
N validators (default: chip_smoke.N_VALIDATORS, 262,144), carries it into the
JAX package as SSZ bytes, runs the reference's `process_slots(state, 128)`
on the CPU and prints the root at slot 128.  chip_smoke.py's phase "epoch"
holds the port's run on the card against this root (POST_EPOCH_ROOT_128).
Memory: a few GiB at the default size, for the two copies of the state.
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
    from consensus_specs_tpu_torch.specs import get_spec
    n = int(sys.argv[1]) if len(sys.argv) > 1 else chip_smoke.N_VALIDATORS

    t0 = time.perf_counter()
    data = chip_smoke.epoch_state(get_spec("phase0", "mainnet"),
                                  n).encode_bytes()
    gc.collect()
    print(f"epoch state of {n} validators built in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    from consensus_specs_tpu.specs import get_spec as reference_spec
    spec = reference_spec("phase0", "mainnet")
    state = spec.BeaconState.decode_bytes(data)
    del data
    t0 = time.perf_counter()
    spec.process_slots(state, chip_smoke.EPOCH_SLOT + 1)
    root = bytes(spec.hash_tree_root(state)).hex()
    print(f"reference process_slots to {chip_smoke.EPOCH_SLOT + 1} in "
          f"{time.perf_counter() - t0:.1f} s")
    print(root)


if __name__ == "__main__":
    main()
