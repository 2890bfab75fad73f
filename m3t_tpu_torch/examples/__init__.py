"""Entry points of the port (``python -m m3t_tpu_torch.examples.<name> ...``), each on
the card unless ``--device cpu`` is given: the dataset evaluations
(``evaluate_<dataset>_dataset``: RBOT, YCB-Video, RTB, OPT and Choi), the parameter
studies (``parameter_study`` and ``parameter_study_<dataset>_dataset``), recorded and
live sequences (``record_camera_sequence``, ``run_on_recorded_sequence``,
``run_on_camera_sequence``), generated trackers (``run_generated_tracker``,
``run_pen_paper_demo``) and the optimizer timing (``optimization_time``)."""
