"""The parity cases of the op registry's last families, numpy only.

One case (or a few) for each op type of ``ops/sequence.py``,
``ops/detection.py``, ``ops/compat.py``, ``ops/niche.py`` and the
fake-quantization ops of ``ops/quantize_kernels.py``: seeded numpy inputs
and the attributes both packages take. ``tests/test_torch_ops_sequence_
detection.py`` and ``tests/test_torch_ops_compat_niche_quant.py`` run
each through the JAX package's registry kernel and the port's on the
CPU; ``chip_smoke.py`` (phase 12p) runs each through the port on the card
and on the CPU. Nothing here imports JAX or torch.

An input is a numpy array, None, or a list of arrays (an op whose first
argument is a list). ``kind`` says how a case is held: ``"value"`` (every
output, integers exactly), ``"resize"`` (a value case the JAX kernel
cannot run: its ``interpolate`` resizes two spatial axes only, so the
port is held to ``jax.image.resize`` itself), ``"random"`` (the op draws: only the
invariants of its family are held) or ``"host"`` (data-dependent output
shape: no ``meta`` shape exists, the op refuses there).
"""
import numpy as np

RTOL, ATOL = 1e-5, 1e-6


class Case:
    """One op call: ``inputs``, ``attrs`` for both packages,
    ``jax_attrs``/``port_attrs`` for one, ``tol`` = (rtol, atol)."""

    def __init__(self, op, inputs, attrs=None, jax_attrs=None, port_attrs=None, tol=None,
                 label="", kind="value"):
        self.op, self.inputs, self.attrs = op, inputs, attrs or {}
        self.jax_attrs, self.port_attrs = jax_attrs or {}, port_attrs or {}
        self.tol = tol or (RTOL, ATOL)
        self.kind = kind
        self.id = op + (f"-{label}" if label else "")


_rng = np.random.RandomState(2027)


def f32(*shape, lo=None, hi=None):
    if lo is not None:
        return _rng.uniform(lo, hi, shape).astype(np.float32)
    return _rng.randn(*shape).astype(np.float32)


def i64(*shape, lo=0, hi=10):
    return _rng.randint(lo, hi, shape).astype(np.int64)


def i32(*shape, lo=0, hi=10):
    return _rng.randint(lo, hi, shape).astype(np.int32)


def boxes(n, size=20.0, lo=0.0, hi=40.0):
    """``n`` boxes (x1, y1, x2, y2) with corners in ``[lo, hi]`` and sides
    up to ``size``."""
    xy = _rng.uniform(lo, hi, (n, 2))
    wh = _rng.uniform(1.0, size, (n, 2))
    return np.concatenate([xy, xy + wh], 1).astype(np.float32)


def clustered_boxes(n, centres=4, jitter=3.0):
    """Boxes around a few centres, so greedy NMS meets chains of
    suppression."""
    c = _rng.uniform(10, 60, (centres, 2))
    pick = c[_rng.randint(0, centres, n)] + _rng.uniform(-jitter, jitter, (n, 2))
    wh = _rng.uniform(8, 16, (n, 2))
    return np.concatenate([pick - wh / 2, pick + wh / 2], 1).astype(np.float32)


# -- ops/sequence.py -----------------------------------------------------------------

_lens = np.array([3, 5, 1, 4], np.int64)
_flat = f32(13, 3)
SEQUENCE = [
    Case("sequence_mask", [_lens], {"maxlen": 6}),
    Case("sequence_mask", [_lens], {"maxlen": None, "out_dtype": "float32"}, label="datalen",
         kind="host"),
    Case("sequence_pad", [_flat, _lens], {"maxlen": 6, "pad_value": -1.0}),
    Case("sequence_pad", [_flat, _lens], {}, label="datalen", kind="host"),
    Case("sequence_unpad", [f32(4, 5, 3), _lens], kind="host"),
    Case("sequence_pool", [f32(4, 5, 3), _lens], {"pooltype": "SUM"}, label="sum"),
    Case("sequence_pool", [f32(4, 5, 3), _lens], {"pooltype": "AVERAGE"}, label="average"),
    Case("sequence_pool", [f32(4, 5, 3), _lens], {"pooltype": "SQRT"}, label="sqrt"),
    Case("sequence_pool", [f32(4, 5, 3), _lens], {"pooltype": "MAX"}, label="max"),
    Case("sequence_pool", [f32(4, 5, 3), _lens], {"pooltype": "MIN"}, label="min"),
    Case("sequence_pool", [f32(4, 5, 3), _lens], {"pooltype": "LAST"}, label="last"),
    Case("segment_pool", [f32(9, 3), np.array([0, 0, 1, 3, 3, 3, 4, 4, 4], np.int64)],
         {"num_segments": 5, "pooltype": "SUM"}, label="sum"),
    Case("segment_pool", [f32(9, 3), np.array([0, 0, 1, 3, 3, 3, 4, 4, 4], np.int64)],
         {"num_segments": 5, "pooltype": "AVERAGE"}, label="average"),
    Case("segment_pool", [f32(9, 3), np.array([0, 0, 1, 3, 3, 3, 4, 4, 4], np.int64)],
         {"num_segments": 5, "pooltype": "MAX"}, label="max"),
    Case("segment_pool", [f32(9, 3), np.array([0, 0, 1, 3, 3, 3, 4, 4, 4], np.int64)],
         {"num_segments": 5, "pooltype": "MIN"}, label="min"),
    Case("sequence_softmax", [f32(4, 5), _lens]),
    Case("sequence_reverse", [f32(4, 5, 2), _lens]),
    Case("sequence_slice", [f32(4, 6, 2), np.array([0, 2, 1, 3], np.int64),
                            np.array([3, 2, 4, 1], np.int64)], {"maxlen": 4}),
    Case("sequence_concat", [f32(4, 5, 2), _lens, f32(4, 3, 2), np.array([2, 0, 3, 1],
                                                                          np.int64)]),
    Case("sequence_expand", [f32(4, 3), np.array([2, 0, 1, 3], np.int64)], kind="host"),
    Case("sequence_enumerate", [i64(7, lo=1, hi=50)], {"win_size": 3, "pad_value": 0}),
    Case("sequence_erase", [i64(12, lo=0, hi=6)], {"tokens": (2, 5)}, kind="host"),
    Case("sequence_conv", [f32(4, 5, 3), _lens, f32(9, 6)], {"context_length": 3}),
    Case("sequence_conv", [f32(4, 5, 3), _lens, f32(12, 6)],
         {"context_length": 4, "context_start": -2}, label="start"),
    Case("sequence_first_step", [f32(4, 5, 3), _lens]),
    Case("sequence_last_step", [f32(4, 5, 3), _lens]),
]


# -- ops/detection.py ----------------------------------------------------------------

_nb = clustered_boxes(40)
_prior = boxes(6)
_img = f32(2, 3, 32, 32)
_fmap = f32(2, 8, 4, 4)
_yolo_anchors = (10, 13, 16, 30, 33, 23)
_delta = f32(12, 4) * 0.2
_anc = boxes(12, size=12.0, hi=30.0)
DETECTION = [
    Case("iou_similarity", [boxes(5), boxes(7)]),
    Case("bbox_overlaps", [boxes(6), boxes(4)]),
    Case("box_clip", [boxes(5, hi=50.0), np.array([30.0, 40.0, 1.0], np.float32)]),
    Case("box_coder", [_prior, f32(6, 4, lo=0.1, hi=0.3), boxes(3)],
         {"code_type": "encode_center_size"}, label="encode"),
    Case("box_coder", [_prior, f32(6, 4, lo=0.1, hi=0.3), f32(3, 6, 4) * 0.3],
         {"code_type": "decode_center_size", "box_normalized": False}, label="decode"),
    Case("prior_box", [_fmap, _img], {"min_sizes": (4.0, 8.0), "max_sizes": (8.0, 16.0),
                                      "aspect_ratios": (2.0,), "flip": True, "clip": True}),
    Case("yolo_box", [f32(2, 3 * 7, 4, 4), np.array([[64, 48], [32, 32]], np.int32)],
         {"anchors": _yolo_anchors, "class_num": 2, "conf_thresh": 0.3,
          "downsample_ratio": 16}),
    Case("roi_align", [f32(2, 3, 8, 8), boxes(5, size=4.0, hi=5.0),
                       np.array([2, 3], np.int32)],
         {"pooled_height": 2, "pooled_width": 3, "spatial_scale": 1.0, "sampling_ratio": 2}),
    Case("nms", [_nb, f32(40, lo=0.0, hi=1.0)], {"iou_threshold": 0.3}),
    Case("nms", [_nb, f32(40, lo=0.0, hi=1.0)], {"iou_threshold": 0.5, "top_k": 6},
         label="topk"),
    Case("multiclass_nms", [_nb, f32(4, 40, lo=0.0, hi=1.0)],
         {"score_threshold": 0.2, "nms_threshold": 0.3, "keep_top_k": 25}),
    Case("multiclass_nms", [_nb, f32(3, 40, lo=0.0, hi=1.0)],
         {"score_threshold": 0.5, "nms_threshold": 0.4, "keep_top_k": 150,
          "background_label": 0}, label="padded"),
    Case("sigmoid_focal_loss", [f32(6, 4), i64(6, hi=5), np.array([3], np.int32)]),
    Case("anchor_generator", [_fmap], {"anchor_sizes": (16.0, 32.0),
                                       "aspect_ratios": (0.5, 1.0, 2.0),
                                       "stride": (8.0, 8.0)}),
    Case("density_prior_box", [_fmap, _img], {"densities": (2, 1), "fixed_sizes": (8.0, 16.0),
                                              "fixed_ratios": (1.0, 2.0), "clip": True}),
    Case("polygon_box_transform", [f32(2, 8, 3, 4)]),
    Case("bipartite_match", [f32(4, 6, lo=0.0, hi=1.0)]),
    Case("bipartite_match", [f32(3, 7, lo=0.0, hi=1.0)],
         {"match_type": "per_prediction", "dist_threshold": 0.4}, label="per_prediction"),
    Case("target_assign", [f32(5, 3), np.array([2, -1, 0, 4, -1, 1], np.int32)],
         {"neg_value": -2.0}),
    Case("box_decoder_and_assign", [boxes(6), f32(6, 4, lo=0.1, hi=0.3), f32(6, 12) * 0.5,
                                    f32(6, 3)]),
    Case("matrix_nms", [_nb, f32(3, 40, lo=0.0, hi=1.0)],
         {"score_threshold": 0.3, "post_threshold": 0.1, "keep_top_k": 30}),
    Case("matrix_nms", [_nb, f32(3, 40, lo=0.0, hi=1.0)],
         {"score_threshold": 0.3, "use_gaussian": True, "keep_top_k": 30}, label="gaussian"),
    Case("locality_aware_nms", [_nb[:20], f32(1, 20, lo=0.0, hi=1.0)],
         {"score_threshold": 0.2, "nms_threshold": 0.3, "keep_top_k": 12}),
    Case("mine_hard_examples", [f32(10, lo=0.0, hi=2.0),
                                np.array([0, -1, -1, 2, -1, -1, -1, 1, -1, -1], np.int32)]),
    Case("mine_hard_examples", [f32(10, lo=0.0, hi=2.0),
                                np.array([0, -1, -1, 2, -1, -1, -1, 1, -1, -1], np.int32)],
         {"sample_size": 4}, label="sample_size"),
    Case("generate_proposals", [f32(12, lo=0.0, hi=1.0), _delta,
                                np.array([40.0, 40.0, 1.0], np.float32), _anc,
                                f32(12, 4, lo=0.5, hi=1.0)],
         {"pre_nms_top_n": 10, "post_nms_top_n": 6, "nms_thresh": 0.5, "min_size": 2.0}),
    Case("distribute_fpn_proposals", [boxes(8, size=300.0, hi=200.0)]),
    Case("collect_fpn_proposals", [f32(3, 5, 4), f32(3, 5, lo=0.0, hi=1.0)],
         {"post_nms_top_n": 7}),
    Case("retinanet_detection_output", [_delta, f32(12, 3, lo=0.0, hi=1.0), _anc,
                                        np.array([40.0, 40.0, 1.0], np.float32)],
         {"score_threshold": 0.3, "keep_top_k": 10, "nms_threshold": 0.4}),
    Case("rpn_target_assign", [boxes(20, size=10.0, hi=30.0), boxes(3, size=10.0, hi=30.0)],
         {"rpn_batch_size_per_im": 8, "use_random": False}, jax_attrs={"key": None}),
]

# yolov3_loss: two images, 6 slots, the last two of each padding; ``x`` of
# a 4x4 grid, three anchors of a nine-anchor set
_gt = np.concatenate([f32(2, 6, 2, lo=0.05, hi=0.95), f32(2, 6, 2, lo=0.05, hi=0.4)], 2)
_gt_lbl = i32(2, 6, hi=3)
_gt_lbl[:, 4:] = -1
_gt[:, 4:] = 0.0
YOLO_ANCHORS = (10, 13, 16, 30, 33, 23, 30, 61, 62, 45, 59, 119, 116, 90, 156, 198, 373, 326)
YOLOV3 = [
    Case("yolov3_loss", [f32(2, 3 * 8, 4, 4), _gt, _gt_lbl],
         {"anchors": YOLO_ANCHORS, "anchor_mask": (0, 1, 2), "class_num": 3,
          "ignore_thresh": 0.5, "downsample_ratio": 8}),
    Case("yolov3_loss", [f32(2, 3 * 8, 4, 4), _gt, _gt_lbl],
         {"anchors": YOLO_ANCHORS, "anchor_mask": (3, 4, 5), "class_num": 3,
          "downsample_ratio": 16, "use_label_smooth": True}, label="smooth"),
]
DETECTION += YOLOV3


# -- ops/compat.py -------------------------------------------------------------------


def _py_double(a, b):
    return a * 2.0, (a + b).astype(np.int32)


_pool_x = f32(2, 3, 6, 6)
_true = i64(3, 2, hi=12)
COMPAT = [
    Case("matmul_v2", [f32(3, 4), f32(4, 2)]),
    Case("reshape2", [f32(2, 6)], {"shape": (3, 4)}),
    Case("transpose2", [f32(2, 3, 4)], {"perm": (2, 0, 1)}),
    Case("squeeze2", [f32(2, 1, 3)], {"axes": (1,)}),
    Case("unsqueeze2", [f32(2, 3)], {"axes": (1,)}),
    Case("flatten2", [f32(2, 3, 4)], {"start_axis": 1}),
    Case("flatten_contiguous_range", [f32(2, 3, 4)], {"start_axis": 0, "stop_axis": 1}),
    Case("top_k_v2", [f32(3, 7)], {"k": 3}),
    Case("lookup_table_v2", [f32(10, 4), i64(5, hi=10)]),
    Case("elementwise_minus", [f32(3, 4), f32(3, 4)]),
    Case("minus", [f32(3, 4), f32(3, 4)]),
    Case("space_to_depth", [f32(1, 2, 4, 4)], {"blocksize": 2}),
    Case("shuffle_channel", [f32(1, 6, 2, 2)], {"group": 3}),
    Case("fill_constant_batch_size_like", [f32(5, 3)],
         {"shape": (1, 4), "value": 2.5, "output_dim_idx": 0}),
    Case("tril_triu", [f32(4, 4)], {"diagonal": 1, "lower": False}),
    Case("nearest_interp", [f32(1, 2, 3, 3)], {"out_h": 6, "out_w": 5}),
    Case("bilinear_interp", [f32(1, 2, 3, 3)], {"out_h": 5, "out_w": 4}),
    Case("bilinear_interp", [f32(1, 2, 6, 6)], {"out_h": 4, "out_w": 3}, label="shrink"),
    Case("trilinear_interp", [f32(1, 1, 2, 3, 3)], {"out_d": 3, "out_h": 4, "out_w": 4},
         kind="resize"),
    Case("bicubic_interp", [f32(1, 1, 4, 4)], {"out_h": 6, "out_w": 7}, tol=(1e-5, 1e-5)),
    Case("bicubic_interp", [f32(1, 1, 7, 6)], {"out_h": 3, "out_w": 4}, tol=(1e-5, 1e-5),
         label="shrink"),
    Case("linear_interp", [f32(1, 2, 5)], {"scale": 2.0, "data_format": "NCW"}, kind="resize"),
    Case("max_pool2d_with_index", [_pool_x], {"kernel_size": 2, "stride": 2}),
    Case("max_pool2d_with_index", [_pool_x], {"kernel_size": 3, "stride": 2, "padding": 1},
         label="padded"),
    Case("max_pool3d_with_index", [f32(1, 2, 4, 4, 4)], {"kernel_size": 2}),
    Case("unpool", [f32(2, 3, 3, 3), np.tile((np.arange(3)[:, None] * 12 + np.arange(3)[None, :]
                                              * 2).astype(np.int32), (2, 3, 1, 1))],
         {"output_size": (6, 6)}),
    Case("squared_l2_norm", [f32(3, 4)]),
    Case("squared_l2_distance", [f32(3, 4), f32(3, 4)]),
    Case("pad_constant_like", [f32(4, 5), f32(2, 3)], {"pad_value": 1.5}),
    Case("lrn", [f32(2, 7, 3, 3, lo=0.0, hi=1.0)], {"n": 5, "k": 2.0}),
    Case("temporal_shift", [f32(4, 8, 2, 2)], {"seg_num": 2, "shift_ratio": 0.25}),
    Case("cos_sim", [f32(4, 6), f32(4, 6)]),
    Case("rank_loss", [f32(4, 1, lo=0.0, hi=1.0), f32(4, 1), f32(4, 1)]),
    Case("margin_rank_loss", [np.array([[1.0], [-1.0], [1.0]], np.float32), f32(3, 1),
                              f32(3, 1)], {"margin": 0.2}),
    Case("bpr_loss", [f32(4, 5), i64(4, 1, hi=5)]),
    Case("center_loss", [f32(5, 3), i64(5, hi=4), f32(4, 3)], {"alpha": 0.5}),
    Case("conv_shift", [f32(2, 7), f32(2, 3)]),
    Case("partial_concat", [[f32(3, 5), f32(3, 5)]], {"start_index": 1, "length": 2}),
    Case("partial_sum", [[f32(3, 5), f32(3, 5), f32(3, 5)]], {"start_index": 2}),
    Case("shuffle_batch", [f32(6, 3)], kind="random"),
    Case("sequence_reshape", [f32(4, 6)], {"new_dim": 3}),
    Case("sequence_scatter", [f32(6, 3), np.array([4, 1, 4], np.int64), f32(3, 3)]),
    Case("row_conv", [f32(2, 5, 3), f32(3, 3)]),
    Case("affine_channel", [f32(2, 3, 2, 2), f32(3), f32(3)]),
    Case("print", [f32(2, 2)], {"message": "tail-case"}, kind="host"),
    Case("py_func", [f32(2, 3), f32(2, 3)],
         {"func": _py_double, "out_shapes": [(2, 3), (2, 3)],
          "out_dtypes": ["float32", "int32"]}, kind="host"),
    Case("shard_index_ref", [i64(6, 1, hi=20)], {"index_num": 20, "nshards": 3, "shard_id": 1}),
    Case("expand_v2", [f32(1, 3)], {"shape": (4, 3)}),
    Case("expand_as_v2", [f32(1, 3), f32(4, 3)]),
    Case("grid_sampler", [f32(1, 2, 4, 4), f32(1, 3, 3, 2, lo=-1.0, hi=1.0)]),
    Case("cross_entropy2", [f32(4, 5), i64(4, hi=5)]),
    Case("kldiv_loss", [np.log(f32(3, 4, lo=0.1, hi=1.0)), f32(3, 4, lo=0.1, hi=1.0)]),
    Case("deformable_conv_v1", [f32(1, 2, 5, 5), f32(1, 18, 3, 3) * 0.5, f32(3, 2, 3, 3)]),
    Case("depthwise_conv2d_transpose", [f32(1, 3, 3, 3), f32(3, 1, 2, 2)], {"stride": 2}),
    Case("frobenius_norm", [f32(3, 4, 2)], {"axis": (1, 2)}),
    Case("l1_norm", [f32(3, 4)]),
    Case("huber_loss", [f32(5), f32(5)], {"delta": 0.5}),
    Case("crop_tensor", [f32(4, 5)], {"shape": (2, 3), "offsets": (1, 2)}),
    Case("crop", [f32(4, 5)], {"shape": (3, 2)}),
    Case("gather_tree", [i64(4, 2, 3, hi=9), i64(4, 2, 3, hi=3)]),
    Case("im2sequence", [f32(2, 2, 5, 5)],
         {"kernels": (2, 3), "strides": (2, 1), "paddings": (1, 0, 0, 1)}),
    Case("fsp", [f32(2, 3, 4, 4), f32(2, 2, 4, 4)]),
    Case("cvm", [f32(4, 5, lo=0.0, hi=3.0), f32(4, 2)]),
    Case("cvm", [f32(4, 5, lo=0.0, hi=3.0), f32(4, 2)], {"use_cvm": False}, label="drop"),
    Case("batch_fc", [f32(2, 3, 4), f32(2, 4, 5), f32(2, 1, 5)]),
    Case("gru_unit", [f32(3, 12), f32(3, 4), f32(4, 12) * 0.5, f32(1, 12)]),
    Case("lstm_unit", [f32(3, 16), f32(3, 4)], {"forget_bias": 1.0}),
    Case("lstmp", [f32(4, 2, 12), f32(3, 2)], {"hidden_size": 3}),
    Case("mean_iou", [i32(20, hi=4), i32(20, hi=4)], {"num_classes": 5}),
    Case("linear_chain_crf", [f32(2, 5, 4), f32(6, 4), i64(2, 5, hi=4)]),
    Case("nce", [f32(3, 4), f32(10, 4), f32(10), i64(3, hi=10), i64(3, 5, hi=10)],
         {"num_total_classes": 10, "num_neg_samples": 5}),
    Case("sample_logits", [f32(3, 12), _true],
         {"num_samples": 4, "use_customized_samples": True,
          "customized_samples": np.concatenate([_true, i64(3, 4, hi=12)], 1),
          "customized_probabilities": f32(3, 6, lo=0.05, hi=0.5)}, jax_attrs={"key": None},
         label="customized"),
    Case("sample_logits", [f32(3, 12), _true], {"num_samples": 5},
         label="drawn", kind="random"),
    Case("filter_by_instag", [f32(5, 3), i64(5, 2, hi=6), np.array([1, 4], np.int64)],
         kind="host"),
]


# -- ops/niche.py --------------------------------------------------------------------

_edges = np.array([[[1, 2], [1, 3], [2, 4], [0, 0]], [[1, 2], [2, 3], [0, 0], [0, 0]]],
                  np.int64)
_ranks = np.array([[1, 1, 0, 2, 1, 0, 0], [2, 1, 1, 0, 0, 2, 2], [0, 1, 0, 1, 1, 1, 2],
                   [3, 3, 3, 1, 0, 2, 2]], np.int64)
NICHE = [
    Case("bilateral_slice", [f32(2, 2, 5, 6), f32(2, 6, 4, 3, 3), f32(2, 5, 6, lo=0.0, hi=1.0)]),
    Case("bilateral_slice", [f32(1, 2, 4, 4), f32(1, 4, 3, 2, 2), f32(1, 4, 4, lo=0.0, hi=1.0)],
         {"has_offset": False}, label="no_offset"),
    Case("rank_attention", [f32(4, 3), _ranks, f32(3 * 3 * 3, 2)], {"max_rank": 3}),
    Case("var_conv_2d", [f32(2, 2, 5, 5), f32(3, 2 * 3 * 3), np.array([5, 3], np.int64),
                         np.array([4, 5], np.int64)],
         {"output_channel": 3, "input_channel": 2, "kernel_h": 3, "kernel_w": 3,
          "stride_h": 2, "stride_w": 1}),
    Case("tree_conv", [f32(2, 5, 3), _edges, f32(3, 3, 4, 2)], {"max_depth": 2}, kind="host"),
    Case("pyramid_hash", [np.array([[3, 7, 11, 0], [5, 2, 9, 13]], np.int32), f32(64 + 4, 1)],
         {"num_emb": 8, "space_len": 64, "pyramid_layer": 3, "rand_len": 4, "seed": 7}),
]


# -- the fake-quantization ops of ops/quantize_kernels.py ----------------------------------

_qx = f32(4, 6) * 3.0
QUANT = [
    Case("fake_quantize_abs_max", [_qx], {"bit_length": 8}),
    Case("fake_quantize_dequantize_abs_max", [_qx], {"bit_length": 8}),
    Case("fake_quantize_range_abs_max", [_qx, np.array([2.0], np.float32)], {"bit_length": 8}),
    Case("fake_quantize_range_abs_max", [_qx, np.array([9.0], np.float32)], {"is_test": True},
         label="test"),
    Case("fake_quantize_moving_average_abs_max",
         [_qx, np.array([1.0], np.float32), np.array([2.0], np.float32),
          np.array([3.0], np.float32)], {"moving_rate": 0.9}),
    Case("fake_quantize_dequantize_moving_average_abs_max",
         [_qx, np.array([1.0], np.float32), np.array([2.0], np.float32),
          np.array([3.0], np.float32)], {"bit_length": 4}),
    Case("fake_channel_wise_quantize_abs_max", [f32(3, 2, 2, 2)], {"quant_axis": 0}),
    Case("fake_channel_wise_quantize_dequantize_abs_max", [f32(2, 4, 3)], {"quant_axis": 1}),
    Case("moving_average_abs_max_scale",
         [_qx, np.array([1.0], np.float32), np.array([2.0], np.float32),
          np.array([3.0], np.float32)], {"moving_rate": 0.8}),
    Case("fake_dequantize_max_abs", [np.round(_qx * 10), np.array([2.0], np.float32)],
         {"max_range": 127.0}),
    Case("fake_channel_wise_dequantize_max_abs", [np.round(f32(3, 4) * 50),
                                                  f32(3, lo=0.5, hi=2.0)],
         {"quant_bits": (8,), "quant_axis": 0}),
]

ALL = SEQUENCE + DETECTION + COMPAT + NICHE + QUANT
