"""The LHCO two-stage generation chain through the PyTorch port (the
counterpart of scripts/generate_data_lhco.py; the work is done by
particle_fm_tpu_torch/lhco_chain.py):

    python3 scripts/torch_generate_data_lhco.py --stage1_run <jet-feature run> \
        --stage2_run <x-jet run> [--stage2_run_y <y-jet run>] [--n_samples N] \
        [--ode_steps S] [--batch_size B] [--recluster] [--metrics] [--out FILE.h5] \
        [--device cpu]
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from particle_fm_tpu_torch.lhco_chain import main  # noqa: E402

if __name__ == "__main__":
    main(sys.argv[1:])
