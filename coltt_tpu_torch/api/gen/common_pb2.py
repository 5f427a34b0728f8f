# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: common.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x0c\x63ommon.proto\x12\x11\x63olttpu.common.v1\"P\n\x05\x45rror\x12\x15\n\rerror_message\x18\x01 \x01(\t\x12\x30\n\nerror_code\x18\x02 \x01(\x0e\x32\x1c.colttpu.common.v1.ErrorCode\"C\n\x08Response\x12\x0e\n\x06status\x18\x01 \x01(\x08\x12\'\n\x05\x65rror\x18\x02 \x01(\x0b\x32\x18.colttpu.common.v1.Error\"\xa0\x01\n\x0cSearchFilter\x12\x12\n\nindex_name\x18\x01 \x01(\t\x12!\n\x02op\x18\x02 \x01(\x0e\x32\x15.colttpu.common.v1.Op\x12\x14\n\nstring_val\x18\x03 \x01(\tH\x00\x12\x11\n\x07int_val\x18\x04 \x01(\x03H\x00\x12\x13\n\tfloat_val\x18\x05 \x01(\x01H\x00\x12\x12\n\x08\x62ool_val\x18\x06 \x01(\x08H\x00\x42\x07\n\x05value\"{\n\x0f\x43ompositeFilter\x12.\n\x02op\x18\x01 \x01(\x0e\x32\".colttpu.common.v1.LogicalOperator\x12\x38\n\x0b\x65xpressions\x18\x02 \x03(\x0b\x32#.colttpu.common.v1.FilterExpression\"\x86\x01\n\x10\x46ilterExpression\x12\x31\n\x06\x66ilter\x18\x01 \x01(\x0b\x32\x1f.colttpu.common.v1.SearchFilterH\x00\x12\x37\n\tcomposite\x18\x02 \x01(\x0b\x32\".colttpu.common.v1.CompositeFilterH\x00\x42\x06\n\x04\x65xpr*%\n\x08\x44istance\x12\n\n\x06\x43OSINE\x10\x00\x12\r\n\tEUCLIDEAN\x10\x01*K\n\x0cQuantization\x12\x08\n\x04NONE\x10\x00\x12\x07\n\x03\x46\x31\x36\x10\x01\x12\x06\n\x02\x46\x38\x10\x02\x12\x08\n\x04\x42\x46\x31\x36\x10\x03\x12\x06\n\x02PQ\x10\x04\x12\x06\n\x02\x42Q\x10\x05\x12\x06\n\x02I8\x10\x06*H\n\tIndexType\x12\n\n\x06STRING\x10\x00\x12\x0b\n\x07INTEGER\x10\x01\x12\t\n\x05\x46LOAT\x10\x02\x12\x0b\n\x07\x42OOLEAN\x10\x03\x12\n\n\x06VECTOR\x10\x04*\x97\x01\n\tErrorCode\x12\r\n\tUNDEFINED\x10\x00\x12\r\n\tRPC_ERROR\x10\x01\x12!\n\x1d\x43OMMUNICATION_SHARD_RPC_ERROR\x10\x02\x12\x1d\n\x19\x43OMMUNICATION_SHARD_ERROR\x10\x03\x12\x11\n\rMARSHAL_ERROR\x10\x04\x12\x17\n\x13INTERNAL_FUNC_ERROR\x10\x05*7\n\x02Op\x12\x06\n\x02\x45Q\x10\x00\x12\x07\n\x03NEQ\x10\x01\x12\x06\n\x02GT\x10\x02\x12\x07\n\x03GTE\x10\x03\x12\x06\n\x02LT\x10\x04\x12\x07\n\x03LTE\x10\x05*\"\n\x0fLogicalOperator\x12\x07\n\x03\x41ND\x10\x00\x12\x06\n\x02OR\x10\x01\x62\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'common_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _DISTANCE._serialized_start=611
  _DISTANCE._serialized_end=648
  _QUANTIZATION._serialized_start=650
  _QUANTIZATION._serialized_end=725
  _INDEXTYPE._serialized_start=727
  _INDEXTYPE._serialized_end=799
  _ERRORCODE._serialized_start=802
  _ERRORCODE._serialized_end=953
  _OP._serialized_start=955
  _OP._serialized_end=1010
  _LOGICALOPERATOR._serialized_start=1012
  _LOGICALOPERATOR._serialized_end=1046
  _ERROR._serialized_start=35
  _ERROR._serialized_end=115
  _RESPONSE._serialized_start=117
  _RESPONSE._serialized_end=184
  _SEARCHFILTER._serialized_start=187
  _SEARCHFILTER._serialized_end=347
  _COMPOSITEFILTER._serialized_start=349
  _COMPOSITEFILTER._serialized_end=472
  _FILTEREXPRESSION._serialized_start=475
  _FILTEREXPRESSION._serialized_end=609
# @@protoc_insertion_point(module_scope)
