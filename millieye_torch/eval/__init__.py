"""The mAP engine and the evaluation harnesses (port of
``millieye_tpu/eval``)."""
from millieye_torch.eval.metrics import (
    compute_ap,
    ap_per_class,
    get_batch_statistics,
    iou_np,
)
from millieye_torch.eval.harness import (
    evaluate_yolo,
    evaluate_refine,
    evaluate_fusion,
    summarize,
    save_pr_curve,
)
