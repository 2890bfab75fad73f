"""The dataset evaluators (port of m3t_tpu/eval/): RBOT, YCB-Video, OPT, Choi and RTB,
with their metrics.  Each evaluator takes ``device`` ("cuda" unless the caller asks for
the CPU) and holds every tensor it builds there."""

from m3t_tpu_torch.eval import metrics
from m3t_tpu_torch.eval.rbot_evaluator import RBOTEvaluator
from m3t_tpu_torch.eval.ycb_evaluator import YCBEvaluator
from m3t_tpu_torch.eval.opt_evaluator import OPTEvaluator
from m3t_tpu_torch.eval.choi_evaluator import ChoiEvaluator
from m3t_tpu_torch.eval.rtb_evaluator import RTBEvaluator
