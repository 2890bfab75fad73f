"""Dataset evaluation entry points of the port (``python -m
m3t_tpu_torch.examples.evaluate_<dataset>_dataset <dataset_dir> <external_dir> ...``):
RBOT, YCB-Video, RTB, OPT and Choi, each on the card unless ``--device cpu`` is given."""
