"""Service layer: the edge gRPC server and client of the PyTorch port.

Generated protobuf modules live in ``coltt_tpu_torch/api/gen``: byte-for-byte
copies of ``coltt_tpu/api/gen`` (protoc output), so both packages speak the
same wire format and can share one process (the descriptor pool accepts an
identical second registration). protoc emits sibling imports
(``import common_pb2``), so the gen directory goes on ``sys.path``.
"""

import os
import sys

_GEN = os.path.join(os.path.dirname(__file__), "gen")
if _GEN not in sys.path:
    sys.path.insert(0, _GEN)
