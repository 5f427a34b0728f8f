"""Wire pieces shared by the RPC builders in ``portbench/rpcs``. Needs the
program's generated protobuf directory on ``sys.path`` (the client
process puts it there)."""

import common_pb2


def filter_proto(spec: dict) -> common_pb2.FilterExpression:
    """A mix's ``filter`` (``{"field": f, "op": "GTE", "int": v}``: an
    integer field compared with ``v``) as a proto filter expression."""
    out = common_pb2.FilterExpression()
    out.filter.index_name = spec["field"]
    out.filter.op = common_pb2.Op.Value(spec["op"])
    out.filter.int_val = int(spec["int"])
    return out
