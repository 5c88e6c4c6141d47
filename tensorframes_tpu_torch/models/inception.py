"""Inception-family conv net as a frozen GraphDef scoring graph.

The PyTorch port keeps its own copy of `tensorframes_tpu/models/inception.py`,
built with the port's builder DSL. At the same seed it draws the same weights
in the same order, so `scoring_graph()` serialises to the JAX model's bytes:
the weights live in the GraphDef, and those bytes are the carry-over between
the packages.

BASELINE config #5 is "Frozen Inception-v3 GraphDef scoring over an
image-tensor DataFrame": the reference's `read_image.py` snippet shipped
a frozen Inception GraphDef to executors and scored image rows. Here the
same shape of workload is native: `InceptionLite` builds an
Inception-v3-style network (conv/BN/relu stem, parallel-branch inception
blocks with 1x1 / stacked-3x3 / pool-projection branches, channel
concat, global average pool, softmax head) directly as TF-compatible
NodeDefs via the builder DSL, with frozen weights baked in as Const
nodes. The exported GraphDef runs through the same importer/lowering as
any TF-frozen model — every op it uses (Conv2D, FusedBatchNorm, MaxPool,
AvgPool, ConcatV2, BiasAdd, Relu, Reshape, MatMul, Softmax) is
conformance-tested against real TF in test_tf_conformance.py.

Channel widths are scaled down from the 299x299 original so tests stay
fast; the topology (branch structure, strides, padding) follows the
Inception-v3 figure-5 blocks.
"""

from __future__ import annotations

import numpy as np

from ..graph import builder as dsl
from ..proto.graphdef import AttrValue
from ..schema import ScalarType, Shape

__all__ = ["InceptionLite"]


class InceptionLite:
    def __init__(
        self,
        image_size: int = 32,
        channels: int = 3,
        width: int = 8,
        num_classes: int = 10,
        seed: int = 0,
    ):
        self.image_size = image_size
        self.channels = channels
        self.width = width
        self.num_classes = num_classes
        self._rng = np.random.RandomState(seed)

    # -- frozen-weight helpers ------------------------------------------
    def _conv_weights(self, kh, kw, cin, cout):
        scale = np.sqrt(2.0 / (kh * kw * cin))
        return (self._rng.randn(kh, kw, cin, cout) * scale).astype(np.float32)

    def _conv_bn_relu(self, x, kh, kw, cin, cout, stride=1, padding="SAME"):
        """Conv2D -> FusedBatchNorm (inference) -> Relu, like Inception's
        conv2d_bn building block."""
        w = dsl.constant(self._conv_weights(kh, kw, cin, cout))
        conv = dsl.Tensor(
            "Conv2D",
            [x, w],
            {
                "T": AttrValue.of_type(ScalarType.float32),
                "strides": AttrValue.of_ints([1, stride, stride, 1]),
                "padding": AttrValue.of_string(padding),
            },
            ScalarType.float32,
        )
        scale = dsl.constant(np.ones(cout, np.float32))
        offset = dsl.constant(
            (0.1 * self._rng.randn(cout)).astype(np.float32)
        )
        mean = dsl.constant(
            (0.01 * self._rng.randn(cout)).astype(np.float32)
        )
        var = dsl.constant(
            (1.0 + 0.1 * self._rng.rand(cout)).astype(np.float32)
        )
        bn = dsl.Tensor(
            "FusedBatchNorm",
            [conv, scale, offset, mean, var],
            {
                "T": AttrValue.of_type(ScalarType.float32),
                "epsilon": AttrValue("f", 1e-3),
                "is_training": AttrValue.of_bool(False),
            },
            ScalarType.float32,
        )
        return dsl.relu(bn)

    def _pool(self, x, op, ksize, stride, padding="SAME"):
        return dsl.Tensor(
            op,
            [x],
            {
                "T": AttrValue.of_type(ScalarType.float32),
                "ksize": AttrValue.of_ints([1, ksize, ksize, 1]),
                "strides": AttrValue.of_ints([1, stride, stride, 1]),
                "padding": AttrValue.of_string(padding),
            },
            ScalarType.float32,
        )

    def _inception_block(self, x, cin, b1, b3r, b3, b5r, b5, bp) -> dsl.Tensor:
        """Inception-v3 figure-5 block: four parallel branches, channel
        concat. b5 is realized as two stacked 3x3s (the v3 factorization)."""
        with dsl.scope("branch1x1"):
            br1 = self._conv_bn_relu(x, 1, 1, cin, b1)
        with dsl.scope("branch3x3"):
            t = self._conv_bn_relu(x, 1, 1, cin, b3r)
            br3 = self._conv_bn_relu(t, 3, 3, b3r, b3)
        with dsl.scope("branch5x5"):
            t = self._conv_bn_relu(x, 1, 1, cin, b5r)
            t = self._conv_bn_relu(t, 3, 3, b5r, b5)
            br5 = self._conv_bn_relu(t, 3, 3, b5, b5)
        with dsl.scope("branch_pool"):
            p = self._pool(x, "AvgPool", 3, 1)
            brp = self._conv_bn_relu(p, 1, 1, cin, bp)
        return dsl.concat([br1, br3, br5, brp], axis=3)

    # -- full scoring graph ---------------------------------------------
    def scoring_graph(self, input_name: str = "images") -> dsl.Tensor:
        """Placeholder (None, H, W, C) -> 'probs' (None, num_classes)."""
        w = self.width
        x = dsl.placeholder(
            ScalarType.float32,
            Shape((None, self.image_size, self.image_size, self.channels)),
            name=input_name,
        )
        with dsl.scope("stem"):
            h = self._conv_bn_relu(x, 3, 3, self.channels, w, stride=2,
                                   padding="VALID")
            h = self._conv_bn_relu(h, 3, 3, w, 2 * w)
            h = self._pool(h, "MaxPool", 3, 2)
        cin = 2 * w
        with dsl.scope("mixed0"):
            h = self._inception_block(h, cin, w, w, 2 * w, w // 2, w, w)
        cin = w + 2 * w + w + w
        with dsl.scope("mixed1"):
            h = self._inception_block(h, cin, w, w, 2 * w, w // 2, w, w)
        cin = w + 2 * w + w + w
        with dsl.scope("head"):
            # global average pool via Mean over spatial dims
            idx = dsl.constant(np.array([1, 2], np.int32))
            pooled = dsl.Tensor(
                "Mean",
                [h, idx],
                {
                    "T": AttrValue.of_type(ScalarType.float32),
                    "keep_dims": AttrValue.of_bool(False),
                    "Tidx": AttrValue.of_type(ScalarType.int32),
                },
                ScalarType.float32,
            )  # (None, cin)
            fc_w = dsl.constant(
                (self._rng.randn(cin, self.num_classes)
                 / np.sqrt(cin)).astype(np.float32)
            )
            fc_b = dsl.constant(np.zeros(self.num_classes, np.float32))
            logits = dsl.Tensor(
                "BiasAdd",
                [dsl.matmul(pooled, fc_w), fc_b],
                {"T": AttrValue.of_type(ScalarType.float32)},
                ScalarType.float32,
            )
        return dsl.softmax(logits).named("probs")
