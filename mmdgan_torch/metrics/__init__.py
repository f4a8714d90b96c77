"""Evaluation metrics of the port (``mmdgan_tpu/metrics``): IS/FID, MS-SSIM,
SWD, the classifiers that feed them and the GraphDef executor."""
