"""STL-10 48x48 MMD-GAN on the PyTorch port — rebuild of my_test_stl.py
(``experiments/stl.py``).

    python -m mmdgan_torch.experiments.stl --skip-sampling --skip-metrics [--device cpu]

Defaults match the JAX entry script: batch 64, lr 2e-4 / 2e-4,
act_k=64^0.125, loss 'rep', num_instance=100000 (my_test_stl.py:36-38,
:51). Data: stl.tfrecords in --data-dir, or --synthetic-data.
"""

import numpy as np

from mmdgan_torch.architectures import stl_architecture
from mmdgan_torch.experiments.runner import build_arg_parser, run_experiment


def main(argv=None):
    parser = build_arg_parser("stl")
    parser.set_defaults(lr_dis=2e-4, lr_gen=2e-4)
    args = parser.parse_args(argv)
    act_k = args.act_k if args.act_k is not None else float(np.power(64.0, 0.125))
    run_experiment(args, stl_architecture(act_k=act_k), "stl", num_instance=100000,
                   input_chw=(3, 48, 48))


if __name__ == "__main__":
    main()
