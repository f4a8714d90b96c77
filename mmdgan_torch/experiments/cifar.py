"""CIFAR-10 32x32 MMD-GAN on the PyTorch port — rebuild of my_test_cifar.py
(``experiments/cifar.py``).

    python -m mmdgan_torch.experiments.cifar --skip-sampling --skip-metrics [--device cpu]
    python -m mmdgan_torch.experiments.cifar --num-class 10 --sample-same-class

Defaults match the reference entry script: batch 64, Adam TTUR
lr_dis=5e-4 / lr_gen=2e-4, act_k=64^0.125, loss 'rep', 8 x 12,500 steps
(my_test_cifar.py:10, :43-44, :56-57, :83). Data: cifar.tfrecords (raw
CHW uint8 under 'x') in --data-dir, or --synthetic-data.
"""

import numpy as np

from mmdgan_torch.architectures import cifar_architecture
from mmdgan_torch.experiments.runner import build_arg_parser, run_experiment


def main(argv=None):
    args = build_arg_parser("cifar").parse_args(argv)
    act_k = args.act_k if args.act_k is not None else float(np.power(64.0, 0.125))
    # labelled runs train the class-conditional variant (cbn generator, dck
    # score head) the reference builds for num_class >= 2
    run_experiment(args, cifar_architecture(act_k=act_k, conditional=args.num_class >= 2),
                   "cifar", num_instance=50000, input_chw=(3, 32, 32))


if __name__ == "__main__":
    main()
