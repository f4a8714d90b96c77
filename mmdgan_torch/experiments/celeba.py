"""CelebA 64x64 MMD-GAN on the PyTorch port — rebuild of my_test_celebA.py
(``experiments/celeba.py``).

    python -m mmdgan_torch.experiments.celeba --skip-sampling --skip-metrics [--device cpu]

Defaults match the JAX entry script: batch 64, lr 1e-4 / 2e-4,
act_k=64^0.1, loss 'rep'; the dataset is --num-files (9) sharded files
celebA_000..008.tfrecords of 22511 images each (my_test_celebA.py:7-9,
:44, :58), or --synthetic-data.
"""

import numpy as np

from mmdgan_torch.architectures import celeba_architecture
from mmdgan_torch.experiments.runner import build_arg_parser, run_experiment


def main(argv=None):
    parser = build_arg_parser("celebA")
    parser.add_argument("--num-files", type=int, default=9)
    parser.set_defaults(lr_dis=1e-4, lr_gen=2e-4)
    args = parser.parse_args(argv)
    act_k = args.act_k if args.act_k is not None else float(np.power(64.0, 0.1))
    filenames = [f"celebA_{i:03d}" for i in range(args.num_files)]
    run_experiment(args, celeba_architecture(act_k=act_k),
                   filenames if not args.synthetic_data else "celebA",
                   num_instance=22511 * args.num_files, input_chw=(3, 64, 64))


if __name__ == "__main__":
    main()
