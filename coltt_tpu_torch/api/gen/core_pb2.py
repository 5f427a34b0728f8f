# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: core.proto
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


DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\ncore.proto\x12\x0f\x63olttpu.core.v1\x1a\x1bgoogle/protobuf/empty.proto\x1a\x1cgoogle/protobuf/struct.proto\x1a\x0c\x63ommon.proto\"<\n\x0e\x43ollectionName\x12\x17\n\x0f\x63ollection_name\x18\x01 \x01(\t\x12\x11\n\twith_size\x18\x02 \x01(\x08\"\xf5\x01\n\nHnswConfig\x12:\n\x10search_algorithm\x18\x01 \x01(\x0e\x32 .colttpu.core.v1.SearchAlgorithm\x12\x18\n\x10level_multiplier\x18\x02 \x01(\x02\x12\n\n\x02\x65\x66\x18\x03 \x01(\x05\x12\x17\n\x0f\x65\x66_construction\x18\x04 \x01(\x05\x12\t\n\x01m\x18\x05 \x01(\x05\x12\r\n\x05m_max\x18\x06 \x01(\x05\x12\x0e\n\x06m_max0\x18\x07 \x01(\x05\x12#\n\x1bheuristic_extend_candidates\x18\x08 \x01(\x08\x12\x1d\n\x15heuristic_keep_pruned\x18\t \x01(\x08\"\xe7\x01\n\x0e\x43ollectionSpec\x12\x17\n\x0f\x63ollection_name\x18\x01 \x01(\t\x12\x36\n\x11\x63ollection_config\x18\x02 \x01(\x0b\x32\x1b.colttpu.core.v1.HnswConfig\x12\x18\n\x10vector_dimension\x18\x03 \x01(\r\x12-\n\x08\x64istance\x18\x04 \x01(\x0e\x32\x1b.colttpu.common.v1.Distance\x12;\n\x12\x63ompression_helper\x18\x05 \x01(\x0e\x32\x1f.colttpu.common.v1.Quantization\"|\n\x12\x43ollectionResponse\x12\x0e\n\x06status\x18\x01 \x01(\x08\x12-\n\x04spec\x18\x02 \x01(\x0b\x32\x1f.colttpu.core.v1.CollectionSpec\x12\'\n\x05\x65rror\x18\x03 \x01(\x0b\x32\x18.colttpu.common.v1.Error\"\x9b\x02\n\x0e\x43ollectionInfo\x12\x17\n\x0f\x63ollection_name\x18\x01 \x01(\t\x12\x36\n\x11\x63ollection_config\x18\x02 \x01(\x0b\x32\x1b.colttpu.core.v1.HnswConfig\x12\x18\n\x10vector_dimension\x18\x03 \x01(\r\x12-\n\x08\x64istance\x18\x04 \x01(\x0e\x32\x1b.colttpu.common.v1.Distance\x12;\n\x12\x63ompression_helper\x18\x05 \x01(\x0e\x32\x1f.colttpu.common.v1.Quantization\x12\x17\n\x0f\x63ollection_size\x18\x06 \x01(\t\x12\x19\n\x11\x63ollection_length\x18\x07 \x01(\x04\"w\n\rCollectionMsg\x12\x0e\n\x06status\x18\x01 \x01(\x08\x12-\n\x04info\x18\x02 \x01(\x0b\x32\x1f.colttpu.core.v1.CollectionInfo\x12\'\n\x05\x65rror\x18\x03 \x01(\x0b\x32\x18.colttpu.common.v1.Error\"_\n\x13ResponseWithMessage\x12\x0e\n\x06status\x18\x01 \x01(\x08\x12\x0f\n\x07message\x18\x02 \x01(\t\x12\'\n\x05\x65rror\x18\x03 \x01(\x0b\x32\x18.colttpu.common.v1.Error\"\xae\x01\n\rDatasetChange\x12\n\n\x02id\x18\x01 \x01(\t\x12\x17\n\x0f\x63ollection_name\x18\x02 \x01(\t\x12\x0e\n\x06vector\x18\x03 \x03(\x02\x12)\n\x08metadata\x18\x04 \x01(\x0b\x32\x17.google.protobuf.Struct\x12=\n\x12index_change_types\x18\x05 \x01(\x0e\x32!.colttpu.core.v1.IndexChangeTypes\"\x97\x01\n\x0b\x42ulkDataset\x12\x17\n\x0f\x63ollection_name\x18\x01 \x01(\t\x12\x13\n\x07vectors\x18\x02 \x03(\x02\x42\x02\x10\x01\x12\r\n\x05\x63ount\x18\x03 \x01(\x04\x12\x0b\n\x03ids\x18\x04 \x03(\t\x12)\n\x08metadata\x18\x05 \x03(\x0b\x32\x17.google.protobuf.Struct\x12\x13\n\x0bvectors_f32\x18\x06 \x01(\x0c\"T\n\x0c\x42ulkResponse\x12\x0e\n\x06status\x18\x01 \x01(\x08\x12\'\n\x05\x65rror\x18\x02 \x01(\x0b\x32\x18.colttpu.common.v1.Error\x12\x0b\n\x03ids\x18\x03 \x03(\t\"\xe4\x01\n\rSearchRequest\x12\x17\n\x0f\x63ollection_name\x18\x01 \x01(\t\x12\x0e\n\x06vector\x18\x02 \x03(\x02\x12\x0c\n\x04topK\x18\x03 \x01(\x04\x12\x1b\n\x13min_score_threshold\x18\x04 \x01(\x02\x12:\n\x06\x66ilter\x18\x05 \x03(\x0b\x32*.colttpu.core.v1.SearchRequest.FilterEntry\x12\x14\n\x0cwith_latency\x18\x06 \x01(\x08\x1a-\n\x0b\x46ilterEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\t:\x02\x38\x01\"\xc1\x01\n\x12SearchBatchRequest\x12\x17\n\x0f\x63ollection_name\x18\x01 \x01(\t\x12\x13\n\x07vectors\x18\x02 \x03(\x02\x42\x02\x10\x01\x12\x13\n\x0bvectors_f32\x18\x03 \x01(\x0c\x12\r\n\x05\x63ount\x18\x04 \x01(\x04\x12\x0c\n\x04topK\x18\x05 \x01(\x04\x12\x1b\n\x13min_score_threshold\x18\x06 \x01(\x02\x12\x18\n\x10include_metadata\x18\x07 \x01(\x08\x12\x14\n\x0cwith_latency\x18\x08 \x01(\x08\"\xbf\x01\n\x13SearchBatchResponse\x12\x0e\n\x06status\x18\x01 \x01(\x08\x12\'\n\x05\x65rror\x18\x02 \x01(\x0b\x32\x18.colttpu.common.v1.Error\x12\x12\n\x06\x63ounts\x18\x03 \x03(\rB\x02\x10\x01\x12\x12\n\x06scores\x18\x04 \x03(\x02\x42\x02\x10\x01\x12\x0b\n\x03ids\x18\x05 \x03(\t\x12)\n\x08metadata\x18\x06 \x03(\x0b\x32\x17.google.protobuf.Struct\x12\x0f\n\x07latency\x18\x07 \x01(\t\"Q\n\tCandidate\x12\n\n\x02id\x18\x01 \x01(\t\x12)\n\x08metadata\x18\x02 \x01(\x0b\x32\x17.google.protobuf.Struct\x12\r\n\x05score\x18\x03 \x01(\x02\"\x8a\x01\n\x0eSearchResponse\x12\x0e\n\x06status\x18\x01 \x01(\x08\x12\'\n\x05\x65rror\x18\x02 \x01(\x0b\x32\x18.colttpu.common.v1.Error\x12.\n\ncandidates\x18\x03 \x03(\x0b\x32\x1a.colttpu.core.v1.Candidate\x12\x0f\n\x07latency\x18\x04 \x01(\t\"[\n\nCompXyDist\x12\x10\n\x08vector_x\x18\x01 \x03(\x02\x12\x10\n\x08vector_y\x18\x02 \x03(\x02\x12)\n\x04\x64ist\x18\x03 \x01(\x0e\x32\x1b.colttpu.common.v1.Distance\"\x17\n\x06XyDist\x12\r\n\x05score\x18\x01 \x01(\x02*,\n\x0fSearchAlgorithm\x12\n\n\x06SIMPLE\x10\x00\x12\r\n\tHEURISTIC\x10\x01*6\n\x10IndexChangeTypes\x12\n\n\x06INSERT\x10\x00\x12\n\n\x06UPDATE\x10\x01\x12\n\n\x06\x44\x45LETE\x10\x02\x32\xc8\t\n\x0b\x43oreService\x12\x38\n\x04Ping\x12\x16.google.protobuf.Empty\x1a\x16.google.protobuf.Empty\"\x00\x12Z\n\x10\x43reateCollection\x12\x1f.colttpu.core.v1.CollectionSpec\x1a#.colttpu.core.v1.CollectionResponse\"\x00\x12P\n\x0e\x44ropCollection\x12\x1f.colttpu.core.v1.CollectionName\x1a\x1b.colttpu.common.v1.Response\"\x00\x12T\n\x0f\x43ollectionInfof\x12\x1f.colttpu.core.v1.CollectionName\x1a\x1e.colttpu.core.v1.CollectionMsg\"\x00\x12S\n\x0eLoadCollection\x12\x1f.colttpu.core.v1.CollectionName\x1a\x1e.colttpu.core.v1.CollectionMsg\"\x00\x12\\\n\x11ReleaseCollection\x12\x1f.colttpu.core.v1.CollectionName\x1a$.colttpu.core.v1.ResponseWithMessage\"\x00\x12G\n\x06Insert\x12\x1e.colttpu.core.v1.DatasetChange\x1a\x1b.colttpu.common.v1.Response\"\x00\x12K\n\nBulkInsert\x12\x1c.colttpu.core.v1.BulkDataset\x1a\x1d.colttpu.core.v1.BulkResponse\"\x00\x12G\n\x06Update\x12\x1e.colttpu.core.v1.DatasetChange\x1a\x1b.colttpu.common.v1.Response\"\x00\x12G\n\x06\x44\x65lete\x12\x1e.colttpu.core.v1.DatasetChange\x1a\x1b.colttpu.common.v1.Response\"\x00\x12Q\n\x0cVectorSearch\x12\x1e.colttpu.core.v1.SearchRequest\x1a\x1f.colttpu.core.v1.SearchResponse\"\x00\x12Q\n\x0c\x46ilterSearch\x12\x1e.colttpu.core.v1.SearchRequest\x1a\x1f.colttpu.core.v1.SearchResponse\"\x00\x12Q\n\x0cHybridSearch\x12\x1e.colttpu.core.v1.SearchRequest\x1a\x1f.colttpu.core.v1.SearchResponse\"\x00\x12`\n\x11VectorSearchBatch\x12#.colttpu.core.v1.SearchBatchRequest\x1a$.colttpu.core.v1.SearchBatchResponse\"\x00\x12\x45\n\x0b\x43ompareDist\x12\x1b.colttpu.core.v1.CompXyDist\x1a\x17.colttpu.core.v1.XyDist\"\x00\x62\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'core_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _BULKDATASET.fields_by_name['vectors']._options = None
  _BULKDATASET.fields_by_name['vectors']._serialized_options = b'\020\001'
  _SEARCHREQUEST_FILTERENTRY._options = None
  _SEARCHREQUEST_FILTERENTRY._serialized_options = b'8\001'
  _SEARCHBATCHREQUEST.fields_by_name['vectors']._options = None
  _SEARCHBATCHREQUEST.fields_by_name['vectors']._serialized_options = b'\020\001'
  _SEARCHBATCHRESPONSE.fields_by_name['counts']._options = None
  _SEARCHBATCHRESPONSE.fields_by_name['counts']._serialized_options = b'\020\001'
  _SEARCHBATCHRESPONSE.fields_by_name['scores']._options = None
  _SEARCHBATCHRESPONSE.fields_by_name['scores']._serialized_options = b'\020\001'
  _SEARCHALGORITHM._serialized_start=2658
  _SEARCHALGORITHM._serialized_end=2702
  _INDEXCHANGETYPES._serialized_start=2704
  _INDEXCHANGETYPES._serialized_end=2758
  _COLLECTIONNAME._serialized_start=104
  _COLLECTIONNAME._serialized_end=164
  _HNSWCONFIG._serialized_start=167
  _HNSWCONFIG._serialized_end=412
  _COLLECTIONSPEC._serialized_start=415
  _COLLECTIONSPEC._serialized_end=646
  _COLLECTIONRESPONSE._serialized_start=648
  _COLLECTIONRESPONSE._serialized_end=772
  _COLLECTIONINFO._serialized_start=775
  _COLLECTIONINFO._serialized_end=1058
  _COLLECTIONMSG._serialized_start=1060
  _COLLECTIONMSG._serialized_end=1179
  _RESPONSEWITHMESSAGE._serialized_start=1181
  _RESPONSEWITHMESSAGE._serialized_end=1276
  _DATASETCHANGE._serialized_start=1279
  _DATASETCHANGE._serialized_end=1453
  _BULKDATASET._serialized_start=1456
  _BULKDATASET._serialized_end=1607
  _BULKRESPONSE._serialized_start=1609
  _BULKRESPONSE._serialized_end=1693
  _SEARCHREQUEST._serialized_start=1696
  _SEARCHREQUEST._serialized_end=1924
  _SEARCHREQUEST_FILTERENTRY._serialized_start=1879
  _SEARCHREQUEST_FILTERENTRY._serialized_end=1924
  _SEARCHBATCHREQUEST._serialized_start=1927
  _SEARCHBATCHREQUEST._serialized_end=2120
  _SEARCHBATCHRESPONSE._serialized_start=2123
  _SEARCHBATCHRESPONSE._serialized_end=2314
  _CANDIDATE._serialized_start=2316
  _CANDIDATE._serialized_end=2397
  _SEARCHRESPONSE._serialized_start=2400
  _SEARCHRESPONSE._serialized_end=2538
  _COMPXYDIST._serialized_start=2540
  _COMPXYDIST._serialized_end=2631
  _XYDIST._serialized_start=2633
  _XYDIST._serialized_end=2656
  _CORESERVICE._serialized_start=2761
  _CORESERVICE._serialized_end=3985
# @@protoc_insertion_point(module_scope)
