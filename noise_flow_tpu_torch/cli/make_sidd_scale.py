"""Generate a SIDD-scale dataset in the real SIDD_Medium on-disk format.

Port of experiments/sidd/make_sidd_scale.py, which imports the JAX package;
this one writes through the port's own copy of the writer
(``noise_flow_tpu_torch.data.mat_fixtures``), so the same arguments give
the same files bit for bit:

- the 56 train + 22 test scene instances of the hardcoded split
  (ref:sidd/sidd_utils.py:888-894), two image tuples each, indexed 010/011
  (the reference's default window start_tr_im_idx=10..end=12);
- 5328x3000 Bayer frames (packed 2664x1500x4, tiled at
  n_patches_per_image=2898 as in ref:job_noise_flow.sh:37);
- .MAT images (v7.3/HDF5 through h5py, or MATLAB v5 through scipy with
  ``--mat_version v5``) and the v5 metadata struct with the NLF at
  UnknownTags[7,0][2][0][0:2];
- (cam, ISO, NLF) cells assigned round-robin over the sorted rows of
  cam_iso_nlf.txt, each scene seeded by its instance id.

About 29 GB of .MAT at full size; writes under <repo>/data (gitignored).

Run:
    python -m noise_flow_tpu_torch.cli.make_sidd_scale [--mat_version v5]
"""

from __future__ import annotations

import argparse
import glob
import os
import sys
import time

from noise_flow_tpu_torch.data.mat_fixtures import write_sidd_scene
from noise_flow_tpu_torch.data.sidd import (
    TEST_INSTANCE_IDS,
    TRAIN_INSTANCE_IDS,
    load_cam_iso_nlf,
)

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def available_mat_version() -> str:
    """v7.3 (the recorded corpus's format) where h5py is installed, else v5."""
    try:
        import h5py  # noqa: F401
        return "v7.3"
    except ImportError:
        return "v5"


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--root",
                   default=os.path.join(REPO, "data", "SIDD_Medium_Raw_synth", "Data"))
    p.add_argument("--height", type=int, default=3000)
    p.add_argument("--width", type=int, default=5328)
    p.add_argument("--n_train", type=int, default=len(TRAIN_INSTANCE_IDS))
    p.add_argument("--n_test", type=int, default=len(TEST_INSTANCE_IDS))
    p.add_argument("--skip_existing", action="store_true", default=True)
    p.add_argument("--mat_version", choices=("v7.3", "v5"), default="v7.3",
                   help="image file format: v7.3 (HDF5, needs h5py) or v5 (scipy)")
    a = p.parse_args(argv)
    if a.mat_version == "v7.3" and available_mat_version() == "v5":   # no silent switch
        raise SystemExit("--mat_version v7.3 writes HDF5 through h5py, which is not "
                         "installed; pass --mat_version v5 to write MATLAB v5 through scipy")

    table = sorted(load_cam_iso_nlf(os.path.join(REPO, "cam_iso_nlf.txt")).items())
    ids = list(TRAIN_INSTANCE_IDS[:a.n_train]) + list(TEST_INSTANCE_IDS[:a.n_test])
    t0 = time.time()
    for k, inst in enumerate(ids):
        cam_iso, (b1, b2) = table[k % len(table)]
        cam_s, iso_s = cam_iso.split("_")
        # any dir starting with the id
        if a.skip_existing and glob.glob(os.path.join(a.root, "%04d" % inst) + "*"):
            continue
        write_sidd_scene(a.root, inst, cam=cam_s, iso=int(iso_s), h=a.height,
                         w=a.width, beta1=b1, beta2=b2, seed=inst,
                         n_images=2, first_idx=10, mat_version=a.mat_version)
        if k % 10 == 0:
            print(f"{k + 1}/{len(ids)} scenes ({cam_iso})  "
                  f"t={time.time() - t0:.0f}s", flush=True)
    print(f"wrote {len(ids)} scene instances under {a.root} "
          f"in {time.time() - t0:.0f}s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
