"""Engine error model.

Reference parity: the proto ``Error{error_message, error_code}`` and
``ErrorCode`` enum shared by all three surfaces (idl/proto/v4/edge.proto,
v3/core.proto), and the per-RPC goroutine + recover() pattern that converts
panics into error responses (core/core.go:60-66, rpcPanicHandler
root_layer/root/rpc.go:117-119). Here: engines raise ``EngineError``; the
service layer catches *all* exceptions and marshals them into status=false
responses, so one bad request can never take the server down.
"""

from __future__ import annotations

import enum


class ErrorCode(enum.IntEnum):
    UNDEFINED = 0
    RPC_ERROR = 1
    COMMUNICATION_SHARD_RPC_ERROR = 2
    COMMUNICATION_SHARD_ERROR = 3
    MARSHAL_ERROR = 4
    INTERNAL_FUNC_ERROR = 5


class EngineError(Exception):
    def __init__(self, message: str, code: ErrorCode = ErrorCode.UNDEFINED):
        super().__init__(message)
        self.message = message
        self.code = code

    def to_dict(self) -> dict:
        return {"error_message": self.message, "error_code": int(self.code)}
