"""Functional operator library of the PyTorch package.

Counterpart of ``paddle_tpu.ops`` (the reference's operator layer):
plain functions on tensors with the JAX signatures, each on the device
of its inputs (a creation op takes ``device``, None: the card). The
hand-written kernels live in ``kernels`` and are routed by the layers
and losses that use them.

Ported modules: ``math``, ``activation``, ``reduction``,
``manipulation``, ``search``, ``random_ops``, ``control_flow``,
``tensor_array``, ``nn_functional`` (conv, pools, BatchNorm and the
common layers' ops), ``loss`` (with the CTC losses), ``metrics_ops``,
``attention``, ``beam``, ``sequence``, ``rnn_functional``, ``crf``,
``sampling``, ``sparse``, ``conv_extra`` and ``detection``; this
namespace exports what ``paddle_tpu.ops`` exports of them.
"""

from . import (activation, attention, beam, control_flow, conv_extra,
               crf, detection, loss, manipulation, math, metrics_ops,
               nn_functional, random_ops, reduction, rnn_functional,
               sampling, search, sequence, sparse, tensor_array)

from .activation import *  # noqa: F401,F403
from .math import *  # noqa: F401,F403
from .reduction import (  # noqa: F401
    all, amax, amin, any, frobenius_norm, l1_norm, logsumexp, max, mean,
    median, min, nanmean, nansum, p_norm, prod, squared_l2_norm, std, sum,
    var)
from .manipulation import *  # noqa: F401,F403
from .nn_functional import *  # noqa: F401,F403
from .loss import *  # noqa: F401,F403
from .search import *  # noqa: F401,F403
from .random_ops import *  # noqa: F401,F403
from .control_flow import (case, cond, fori_loop, scan,  # noqa: F401
                           static_rnn, switch_case, while_loop)
from .sequence import *  # noqa: F401,F403
from .metrics_ops import (accuracy, auc_from_stats,  # noqa: F401
                          auc_stats, mean_iou, positive_negative_pair,
                          precision_recall_stats)
from .sparse import RowSlices, embedding_grad, merge_rows  # noqa: F401
from .sparse import scatter_apply, to_dense  # noqa: F401
from .crf import chunk_eval, crf_decoding, linear_chain_crf  # noqa: F401
from .beam import (beam_search, beam_search_decode,  # noqa: F401
                   beam_search_step, gather_tree)
from .sampling import (hash_bucket, hsigmoid_loss, nce_loss,  # noqa: F401
                       sampled_softmax_with_cross_entropy)
from .rnn_functional import (dynamic_gru, dynamic_lstm,  # noqa: F401
                             dynamic_lstmp, gru_unit, lstm, lstm_unit)
from .detection import (bipartite_match, box_clip, box_coder,  # noqa
                        collect_fpn_proposals, density_prior_box,
                        generate_mask_labels,
                        generate_proposal_labels, generate_proposals,
                        iou_similarity, locality_aware_nms, matrix_nms,
                        multiclass_nms, prior_box, retinanet_detection_output,
                        retinanet_target_assign, roi_align, roi_pool,
                        rpn_target_assign, ssd_loss,
                        target_assign, yolo_box, yolov3_loss)
# detection.sigmoid_focal_loss (multiclass, over fg_num) is not exported
# here, as in the JAX package: loss.py's elementwise one owns the name
from .conv_extra import *  # noqa: F401,F403
from .tensor_array import (TensorArray, array_length,  # noqa: F401
                           array_read, array_to_lod_tensor, array_write,
                           create_array, lod_tensor_to_array,
                           tensor_array_to_tensor)
from .control_flow import print_op, py_func  # noqa: F401

_MODULES = ["activation", "attention", "beam", "control_flow",
            "conv_extra", "crf", "detection", "loss", "manipulation", "math", "metrics_ops", "nn_functional",
            "random_ops", "reduction", "rnn_functional", "sampling",
            "search", "sequence", "sparse", "tensor_array"]

__all__ = _MODULES + sorted(
    set(activation.__all__) | set(math.__all__) | set(reduction.__all__)
    | set(manipulation.__all__) | set(nn_functional.__all__)
    | set(loss.__all__) | set(search.__all__) | set(random_ops.__all__)
    | set(sequence.__all__) | set(crf.__all__) | set(sampling.__all__)
    | set(rnn_functional.__all__) | set(conv_extra.__all__)
    | {"bipartite_match", "box_clip", "box_coder", "collect_fpn_proposals",
       "density_prior_box", "generate_mask_labels",
       "generate_proposal_labels", "generate_proposals", "iou_similarity",
       "locality_aware_nms", "matrix_nms", "multiclass_nms", "prior_box",
       "retinanet_detection_output", "retinanet_target_assign",
       "roi_align", "roi_pool", "rpn_target_assign", "ssd_loss",
       "target_assign", "yolo_box", "yolov3_loss"}
    | {"RowSlices", "embedding_grad", "merge_rows", "scatter_apply",
       "to_dense"}
    | {"case", "cond", "fori_loop", "scan", "static_rnn", "switch_case",
       "while_loop", "print_op", "py_func", "accuracy", "auc_from_stats",
       "auc_stats", "mean_iou", "positive_negative_pair",
       "precision_recall_stats", "beam_search", "beam_search_decode",
       "beam_search_step", "gather_tree", "TensorArray", "array_length",
       "array_read", "array_to_lod_tensor", "array_write", "create_array",
       "lod_tensor_to_array", "tensor_array_to_tensor"})
