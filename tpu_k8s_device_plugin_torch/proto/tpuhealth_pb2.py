# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: tpuhealth.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x0ftpuhealth.proto\x12\ttpuhealth\"i\n\x08TpuState\x12\n\n\x02id\x18\x01 \x01(\t\x12\x13\n\x0b\x61\x63\x63\x65l_index\x18\x02 \x01(\x05\x12\x0e\n\x06health\x18\x03 \x01(\t\x12\x1c\n\x14\x61ssociated_workloads\x18\x04 \x03(\t\x12\x0e\n\x06\x64\x65vice\x18\x05 \x01(\t\" \n\x12GetTpuStateRequest\x12\n\n\x02id\x18\x01 \x01(\t\"9\n\x13GetTpuStateResponse\x12\"\n\x05state\x18\x01 \x01(\x0b\x32\x13.tpuhealth.TpuState\"\x15\n\x13ListTpuStateRequest\";\n\x14ListTpuStateResponse\x12#\n\x06states\x18\x01 \x03(\x0b\x32\x13.tpuhealth.TpuState*4\n\tTpuHealth\x12\x0b\n\x07UNKNOWN\x10\x00\x12\x0b\n\x07HEALTHY\x10\x01\x12\r\n\tUNHEALTHY\x10\x02\x32\xad\x01\n\x10TpuHealthService\x12N\n\x0bGetTpuState\x12\x1d.tpuhealth.GetTpuStateRequest\x1a\x1e.tpuhealth.GetTpuStateResponse\"\x00\x12I\n\x04List\x12\x1e.tpuhealth.ListTpuStateRequest\x1a\x1f.tpuhealth.ListTpuStateResponse\"\x00\x62\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'tpuhealth_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _TPUHEALTH._serialized_start=314
  _TPUHEALTH._serialized_end=366
  _TPUSTATE._serialized_start=30
  _TPUSTATE._serialized_end=135
  _GETTPUSTATEREQUEST._serialized_start=137
  _GETTPUSTATEREQUEST._serialized_end=169
  _GETTPUSTATERESPONSE._serialized_start=171
  _GETTPUSTATERESPONSE._serialized_end=228
  _LISTTPUSTATEREQUEST._serialized_start=230
  _LISTTPUSTATEREQUEST._serialized_end=251
  _LISTTPUSTATERESPONSE._serialized_start=253
  _LISTTPUSTATERESPONSE._serialized_end=312
  _TPUHEALTHSERVICE._serialized_start=369
  _TPUHEALTHSERVICE._serialized_end=542
# @@protoc_insertion_point(module_scope)
