# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: edge.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()


from google.protobuf import empty_pb2 as google_dot_protobuf_dot_empty__pb2
from google.protobuf import struct_pb2 as google_dot_protobuf_dot_struct__pb2
import common_pb2 as common__pb2


DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\nedge.proto\x12\x0f\x63olttpu.edge.v1\x1a\x1bgoogle/protobuf/empty.proto\x1a\x1cgoogle/protobuf/struct.proto\x1a\x0c\x63ommon.proto\"<\n\x0e\x43ollectionName\x12\x17\n\x0f\x63ollection_name\x18\x01 \x01(\t\x12\x11\n\twith_size\x18\x02 \x01(\x08\"|\n\nIndexField\x12\x12\n\nindex_name\x18\x01 \x01(\t\x12\x30\n\nindex_type\x18\x02 \x01(\x0e\x32\x1c.colttpu.common.v1.IndexType\x12\x13\n\x0b\x65nable_null\x18\x03 \x01(\x08\x12\x13\n\x0bprimary_key\x18\x04 \x01(\x08\"\xd8\x01\n\nCollection\x12\x17\n\x0f\x63ollection_name\x18\x01 \x01(\t\x12*\n\x05index\x18\x02 \x03(\x0b\x32\x1b.colttpu.edge.v1.IndexField\x12-\n\x08\x64istance\x18\x03 \x01(\x0e\x32\x1b.colttpu.common.v1.Distance\x12\x35\n\x0cquantization\x18\x04 \x01(\x0e\x32\x1f.colttpu.common.v1.Quantization\x12\x0b\n\x03\x64im\x18\x05 \x01(\r\x12\x12\n\nversioning\x18\x06 \x01(\x08\"~\n\x12\x43ollectionResponse\x12/\n\ncollection\x18\x01 \x01(\x0b\x32\x1b.colttpu.edge.v1.Collection\x12\x0e\n\x06status\x18\x02 \x01(\x08\x12\'\n\x05\x65rror\x18\x03 \x01(\x0b\x32\x18.colttpu.common.v1.Error\"\xbe\x01\n\x10\x43ollectionDetail\x12/\n\ncollection\x18\x01 \x01(\x0b\x32\x1b.colttpu.edge.v1.Collection\x12\x17\n\x0f\x63ollection_size\x18\x02 \x01(\r\x12\x19\n\x11\x63ollection_memory\x18\x03 \x01(\x04\x12\x0c\n\x04load\x18\x04 \x01(\x08\x12\x0e\n\x06status\x18\x05 \x01(\x08\x12\'\n\x05\x65rror\x18\x06 \x01(\x0b\x32\x18.colttpu.common.v1.Error\"\xaa\x01\n\x0bIndexChange\x12\x17\n\x0f\x63ollection_name\x18\x01 \x01(\t\x12\x13\n\x0bprimary_key\x18\x02 \x01(\t\x12)\n\x08metadata\x18\x03 \x01(\x0b\x32\x17.google.protobuf.Struct\x12\x0f\n\x07vectors\x18\x04 \x03(\x02\x12\x31\n\x07\x63hanged\x18\x05 \x01(\x0e\x32 .colttpu.edge.v1.IndexChangeType\"\xa4\x01\n\x0f\x42ulkIndexChange\x12\x17\n\x0f\x63ollection_name\x18\x01 \x01(\t\x12\x13\n\x07vectors\x18\x02 \x03(\x02\x42\x02\x10\x01\x12\r\n\x05\x63ount\x18\x03 \x01(\x04\x12\x14\n\x0cprimary_keys\x18\x04 \x03(\t\x12)\n\x08metadata\x18\x05 \x03(\x0b\x32\x17.google.protobuf.Struct\x12\x13\n\x0bvectors_f32\x18\x06 \x01(\x0c\"\xb6\x01\n\x0bSearchIndex\x12\x17\n\x0f\x63ollection_name\x18\x01 \x01(\t\x12\x0e\n\x06vector\x18\x02 \x03(\x02\x12\x0e\n\x06offset\x18\x03 \x01(\x04\x12\r\n\x05limit\x18\x04 \x01(\x04\x12>\n\x11\x66ilter_expression\x18\x05 \x01(\x0b\x32#.colttpu.common.v1.FilterExpression\x12\x1f\n\x17high_resource_avaliable\x18\x06 \x01(\x08\"\xfe\x01\n\x10SearchBatchIndex\x12\x17\n\x0f\x63ollection_name\x18\x01 \x01(\t\x12\x13\n\x07vectors\x18\x02 \x03(\x02\x42\x02\x10\x01\x12\x13\n\x0bvectors_f32\x18\x03 \x01(\x0c\x12\r\n\x05\x63ount\x18\x04 \x01(\x04\x12\r\n\x05limit\x18\x05 \x01(\x04\x12\x0e\n\x06offset\x18\x06 \x01(\x04\x12>\n\x11\x66ilter_expression\x18\x07 \x01(\x0b\x32#.colttpu.common.v1.FilterExpression\x12\x1f\n\x17high_resource_avaliable\x18\x08 \x01(\x08\x12\x18\n\x10include_metadata\x18\t \x01(\x08\"\xae\x01\n\x13SearchBatchResponse\x12\x0e\n\x06status\x18\x01 \x01(\x08\x12\'\n\x05\x65rror\x18\x02 \x01(\x0b\x32\x18.colttpu.common.v1.Error\x12\x12\n\x06\x63ounts\x18\x03 \x03(\rB\x02\x10\x01\x12\x12\n\x06scores\x18\x04 \x03(\x02\x42\x02\x10\x01\x12\x0b\n\x03ids\x18\x05 \x03(\t\x12)\n\x08metadata\x18\x06 \x03(\x0b\x32\x17.google.protobuf.Struct\"Q\n\tCandidate\x12)\n\x08metadata\x18\x01 \x01(\x0b\x32\x17.google.protobuf.Struct\x12\r\n\x05score\x18\x02 \x01(\x02\x12\n\n\x02id\x18\x03 \x01(\t\"y\n\x0eSearchResponse\x12\x0e\n\x06status\x18\x01 \x01(\x08\x12\'\n\x05\x65rror\x18\x02 \x01(\x0b\x32\x18.colttpu.common.v1.Error\x12.\n\ncandidates\x18\x03 \x03(\x0b\x32\x1a.colttpu.edge.v1.Candidate**\n\x0fIndexChangeType\x12\x0b\n\x07\x43HANGED\x10\x00\x12\n\n\x06\x44\x45LETE\x10\x01\x32\xf9\x06\n\x0b\x45\x64geService\x12\x38\n\x04Ping\x12\x16.google.protobuf.Empty\x1a\x16.google.protobuf.Empty\"\x00\x12V\n\x10\x43reateCollection\x12\x1b.colttpu.edge.v1.Collection\x1a#.colttpu.edge.v1.CollectionResponse\"\x00\x12R\n\x10\x44\x65leteCollection\x12\x1f.colttpu.edge.v1.CollectionName\x1a\x1b.colttpu.common.v1.Response\"\x00\x12U\n\rGetCollection\x12\x1f.colttpu.edge.v1.CollectionName\x1a!.colttpu.edge.v1.CollectionDetail\"\x00\x12V\n\x0eLoadCollection\x12\x1f.colttpu.edge.v1.CollectionName\x1a!.colttpu.edge.v1.CollectionDetail\"\x00\x12S\n\x11ReleaseCollection\x12\x1f.colttpu.edge.v1.CollectionName\x1a\x1b.colttpu.common.v1.Response\"\x00\x12G\n\x05\x46lush\x12\x1f.colttpu.edge.v1.CollectionName\x1a\x1b.colttpu.common.v1.Response\"\x00\x12\x44\n\x05Index\x12\x1c.colttpu.edge.v1.IndexChange\x1a\x1b.colttpu.common.v1.Response\"\x00\x12L\n\tBulkIndex\x12 .colttpu.edge.v1.BulkIndexChange\x1a\x1b.colttpu.common.v1.Response\"\x00\x12I\n\x06Search\x12\x1c.colttpu.edge.v1.SearchIndex\x1a\x1f.colttpu.edge.v1.SearchResponse\"\x00\x12X\n\x0bSearchBatch\x12!.colttpu.edge.v1.SearchBatchIndex\x1a$.colttpu.edge.v1.SearchBatchResponse\"\x00\x62\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'edge_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _BULKINDEXCHANGE.fields_by_name['vectors']._options = None
  _BULKINDEXCHANGE.fields_by_name['vectors']._serialized_options = b'\020\001'
  _SEARCHBATCHINDEX.fields_by_name['vectors']._options = None
  _SEARCHBATCHINDEX.fields_by_name['vectors']._serialized_options = b'\020\001'
  _SEARCHBATCHRESPONSE.fields_by_name['counts']._options = None
  _SEARCHBATCHRESPONSE.fields_by_name['counts']._serialized_options = b'\020\001'
  _SEARCHBATCHRESPONSE.fields_by_name['scores']._options = None
  _SEARCHBATCHRESPONSE.fields_by_name['scores']._serialized_options = b'\020\001'
  _INDEXCHANGETYPE._serialized_start=1997
  _INDEXCHANGETYPE._serialized_end=2039
  _COLLECTIONNAME._serialized_start=104
  _COLLECTIONNAME._serialized_end=164
  _INDEXFIELD._serialized_start=166
  _INDEXFIELD._serialized_end=290
  _COLLECTION._serialized_start=293
  _COLLECTION._serialized_end=509
  _COLLECTIONRESPONSE._serialized_start=511
  _COLLECTIONRESPONSE._serialized_end=637
  _COLLECTIONDETAIL._serialized_start=640
  _COLLECTIONDETAIL._serialized_end=830
  _INDEXCHANGE._serialized_start=833
  _INDEXCHANGE._serialized_end=1003
  _BULKINDEXCHANGE._serialized_start=1006
  _BULKINDEXCHANGE._serialized_end=1170
  _SEARCHINDEX._serialized_start=1173
  _SEARCHINDEX._serialized_end=1355
  _SEARCHBATCHINDEX._serialized_start=1358
  _SEARCHBATCHINDEX._serialized_end=1612
  _SEARCHBATCHRESPONSE._serialized_start=1615
  _SEARCHBATCHRESPONSE._serialized_end=1789
  _CANDIDATE._serialized_start=1791
  _CANDIDATE._serialized_end=1872
  _SEARCHRESPONSE._serialized_start=1874
  _SEARCHRESPONSE._serialized_end=1995
  _EDGESERVICE._serialized_start=2042
  _EDGESERVICE._serialized_end=2931
# @@protoc_insertion_point(module_scope)
