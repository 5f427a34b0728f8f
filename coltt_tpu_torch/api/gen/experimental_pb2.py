# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: experimental.proto
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


DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x12\x65xperimental.proto\x12\x17\x63olttpu.experimental.v1\x1a\x1bgoogle/protobuf/empty.proto\x1a\x1cgoogle/protobuf/struct.proto\x1a\x0c\x63ommon.proto\"<\n\x0e\x43ollectionName\x12\x17\n\x0f\x63ollection_name\x18\x01 \x01(\t\x12\x11\n\twith_size\x18\x02 \x01(\x08\"g\n\nIndexField\x12\x12\n\nindex_name\x18\x01 \x01(\t\x12\x30\n\nindex_type\x18\x02 \x01(\x0e\x32\x1c.colttpu.common.v1.IndexType\x12\x13\n\x0b\x65nable_null\x18\x03 \x01(\x08\"\xe0\x01\n\nCollection\x12\x17\n\x0f\x63ollection_name\x18\x01 \x01(\t\x12\x32\n\x05index\x18\x02 \x03(\x0b\x32#.colttpu.experimental.v1.IndexField\x12-\n\x08\x64istance\x18\x03 \x01(\x0e\x32\x1b.colttpu.common.v1.Distance\x12\x35\n\x0cquantization\x18\x04 \x01(\x0e\x32\x1f.colttpu.common.v1.Quantization\x12\x0b\n\x03\x64im\x18\x05 \x01(\r\x12\x12\n\nversioning\x18\x06 \x01(\x08\"\x86\x01\n\x12\x43ollectionResponse\x12\x37\n\ncollection\x18\x01 \x01(\x0b\x32#.colttpu.experimental.v1.Collection\x12\x0e\n\x06status\x18\x02 \x01(\x08\x12\'\n\x05\x65rror\x18\x03 \x01(\x0b\x32\x18.colttpu.common.v1.Error\"\xc6\x01\n\x10\x43ollectionDetail\x12\x37\n\ncollection\x18\x01 \x01(\x0b\x32#.colttpu.experimental.v1.Collection\x12\x17\n\x0f\x63ollection_size\x18\x02 \x01(\r\x12\x19\n\x11\x63ollection_memory\x18\x03 \x01(\x04\x12\x0c\n\x04load\x18\x04 \x01(\x08\x12\x0e\n\x06status\x18\x05 \x01(\x08\x12\'\n\x05\x65rror\x18\x06 \x01(\x0b\x32\x18.colttpu.common.v1.Error\"1\n\x0bVectorIndex\x12\x12\n\nindex_name\x18\x01 \x01(\t\x12\x0e\n\x06vector\x18\x02 \x03(\x02\"\xcf\x01\n\x0bIndexChange\x12\n\n\x02id\x18\x01 \x01(\t\x12\x17\n\x0f\x63ollection_name\x18\x02 \x01(\t\x12)\n\x08metadata\x18\x03 \x01(\x0b\x32\x17.google.protobuf.Struct\x12\x35\n\x07vectors\x18\x04 \x03(\x0b\x32$.colttpu.experimental.v1.VectorIndex\x12\x39\n\x07\x63hanged\x18\x05 \x01(\x0e\x32(.colttpu.experimental.v1.IndexChangeType\"]\n\x10MultiVectorIndex\x12\x12\n\nindex_name\x18\x01 \x01(\t\x12\x0e\n\x06vector\x18\x02 \x03(\x02\x12\x16\n\x0einclude_or_not\x18\x03 \x01(\x08\x12\r\n\x05ratio\x18\x04 \x01(\r\"\x95\x01\n\x10SearchMultiIndex\x12\x17\n\x0f\x63ollection_name\x18\x01 \x01(\t\x12\x39\n\x06vector\x18\x02 \x03(\x0b\x32).colttpu.experimental.v1.MultiVectorIndex\x12\x0c\n\x04topK\x18\x03 \x01(\x04\x12\x1f\n\x17high_resource_avaliable\x18\x04 \x01(\x08\"P\n\x10VectorFieldBlock\x12\x12\n\nindex_name\x18\x01 \x01(\t\x12\x13\n\x07vectors\x18\x02 \x03(\x02\x42\x02\x10\x01\x12\x13\n\x0bvectors_f32\x18\x03 \x01(\x0c\"\xac\x01\n\x0f\x42ulkIndexChange\x12\x17\n\x0f\x63ollection_name\x18\x01 \x01(\t\x12\x39\n\x06\x66ields\x18\x02 \x03(\x0b\x32).colttpu.experimental.v1.VectorFieldBlock\x12\r\n\x05\x63ount\x18\x03 \x01(\r\x12\x0b\n\x03ids\x18\x04 \x03(\t\x12)\n\x08metadata\x18\x05 \x03(\x0b\x32\x17.google.protobuf.Struct\"|\n\x15MultiVectorIndexBatch\x12\x12\n\nindex_name\x18\x01 \x01(\t\x12\x13\n\x07vectors\x18\x02 \x03(\x02\x42\x02\x10\x01\x12\x13\n\x0bvectors_f32\x18\x03 \x01(\x0c\x12\x16\n\x0einclude_or_not\x18\x04 \x01(\x08\x12\r\n\x05ratio\x18\x05 \x01(\r\"\xc8\x01\n\x15SearchMultiIndexBatch\x12\x17\n\x0f\x63ollection_name\x18\x01 \x01(\t\x12>\n\x06vector\x18\x02 \x03(\x0b\x32..colttpu.experimental.v1.MultiVectorIndexBatch\x12\r\n\x05\x63ount\x18\x03 \x01(\r\x12\x0c\n\x04topK\x18\x04 \x01(\x04\x12\x1f\n\x17high_resource_avaliable\x18\x05 \x01(\x08\x12\x18\n\x10include_metadata\x18\x06 \x01(\x08\"\xae\x01\n\x13SearchBatchResponse\x12\x0e\n\x06status\x18\x01 \x01(\x08\x12\'\n\x05\x65rror\x18\x02 \x01(\x0b\x32\x18.colttpu.common.v1.Error\x12\x12\n\x06\x63ounts\x18\x03 \x03(\rB\x02\x10\x01\x12\x12\n\x06scores\x18\x04 \x03(\x02\x42\x02\x10\x01\x12\x0b\n\x03ids\x18\x05 \x03(\t\x12)\n\x08metadata\x18\x06 \x03(\x0b\x32\x17.google.protobuf.Struct\"Q\n\tCandidate\x12\n\n\x02id\x18\x01 \x01(\t\x12)\n\x08metadata\x18\x02 \x01(\x0b\x32\x17.google.protobuf.Struct\x12\r\n\x05score\x18\x03 \x01(\x02\"\x81\x01\n\x0eSearchResponse\x12\x0e\n\x06status\x18\x01 \x01(\x08\x12\'\n\x05\x65rror\x18\x02 \x01(\x0b\x32\x18.colttpu.common.v1.Error\x12\x36\n\ncandidates\x18\x03 \x03(\x0b\x32\".colttpu.experimental.v1.Candidate**\n\x0fIndexChangeType\x12\x0b\n\x07\x43HANGED\x10\x00\x12\n\n\x06\x44\x45LETE\x10\x01\x32\x9a\x08\n\x1e\x45xperimentalMultiVectorService\x12\x38\n\x04Ping\x12\x16.google.protobuf.Empty\x1a\x16.google.protobuf.Empty\"\x00\x12\x66\n\x10\x43reateCollection\x12#.colttpu.experimental.v1.Collection\x1a+.colttpu.experimental.v1.CollectionResponse\"\x00\x12Z\n\x10\x44\x65leteCollection\x12\'.colttpu.experimental.v1.CollectionName\x1a\x1b.colttpu.common.v1.Response\"\x00\x12\x65\n\rGetCollection\x12\'.colttpu.experimental.v1.CollectionName\x1a).colttpu.experimental.v1.CollectionDetail\"\x00\x12\x66\n\x0eLoadCollection\x12\'.colttpu.experimental.v1.CollectionName\x1a).colttpu.experimental.v1.CollectionDetail\"\x00\x12[\n\x11ReleaseCollection\x12\'.colttpu.experimental.v1.CollectionName\x1a\x1b.colttpu.common.v1.Response\"\x00\x12O\n\x05\x46lush\x12\'.colttpu.experimental.v1.CollectionName\x1a\x1b.colttpu.common.v1.Response\"\x00\x12L\n\x05Index\x12$.colttpu.experimental.v1.IndexChange\x1a\x1b.colttpu.common.v1.Response\"\x00\x12T\n\tBulkIndex\x12(.colttpu.experimental.v1.BulkIndexChange\x1a\x1b.colttpu.common.v1.Response\"\x00\x12\x64\n\x0cVectorSearch\x12).colttpu.experimental.v1.SearchMultiIndex\x1a\'.colttpu.experimental.v1.SearchResponse\"\x00\x12s\n\x11VectorSearchBatch\x12..colttpu.experimental.v1.SearchMultiIndexBatch\x1a,.colttpu.experimental.v1.SearchBatchResponse\"\x00\x62\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'experimental_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _VECTORFIELDBLOCK.fields_by_name['vectors']._options = None
  _VECTORFIELDBLOCK.fields_by_name['vectors']._serialized_options = b'\020\001'
  _MULTIVECTORINDEXBATCH.fields_by_name['vectors']._options = None
  _MULTIVECTORINDEXBATCH.fields_by_name['vectors']._serialized_options = b'\020\001'
  _SEARCHBATCHRESPONSE.fields_by_name['counts']._options = None
  _SEARCHBATCHRESPONSE.fields_by_name['counts']._serialized_options = b'\020\001'
  _SEARCHBATCHRESPONSE.fields_by_name['scores']._options = None
  _SEARCHBATCHRESPONSE.fields_by_name['scores']._serialized_options = b'\020\001'
  _INDEXCHANGETYPE._serialized_start=2338
  _INDEXCHANGETYPE._serialized_end=2380
  _COLLECTIONNAME._serialized_start=120
  _COLLECTIONNAME._serialized_end=180
  _INDEXFIELD._serialized_start=182
  _INDEXFIELD._serialized_end=285
  _COLLECTION._serialized_start=288
  _COLLECTION._serialized_end=512
  _COLLECTIONRESPONSE._serialized_start=515
  _COLLECTIONRESPONSE._serialized_end=649
  _COLLECTIONDETAIL._serialized_start=652
  _COLLECTIONDETAIL._serialized_end=850
  _VECTORINDEX._serialized_start=852
  _VECTORINDEX._serialized_end=901
  _INDEXCHANGE._serialized_start=904
  _INDEXCHANGE._serialized_end=1111
  _MULTIVECTORINDEX._serialized_start=1113
  _MULTIVECTORINDEX._serialized_end=1206
  _SEARCHMULTIINDEX._serialized_start=1209
  _SEARCHMULTIINDEX._serialized_end=1358
  _VECTORFIELDBLOCK._serialized_start=1360
  _VECTORFIELDBLOCK._serialized_end=1440
  _BULKINDEXCHANGE._serialized_start=1443
  _BULKINDEXCHANGE._serialized_end=1615
  _MULTIVECTORINDEXBATCH._serialized_start=1617
  _MULTIVECTORINDEXBATCH._serialized_end=1741
  _SEARCHMULTIINDEXBATCH._serialized_start=1744
  _SEARCHMULTIINDEXBATCH._serialized_end=1944
  _SEARCHBATCHRESPONSE._serialized_start=1947
  _SEARCHBATCHRESPONSE._serialized_end=2121
  _CANDIDATE._serialized_start=2123
  _CANDIDATE._serialized_end=2204
  _SEARCHRESPONSE._serialized_start=2207
  _SEARCHRESPONSE._serialized_end=2336
  _EXPERIMENTALMULTIVECTORSERVICE._serialized_start=2383
  _EXPERIMENTALMULTIVECTORSERVICE._serialized_end=3433
# @@protoc_insertion_point(module_scope)
