# -*- coding: utf-8 -*-
# Generated protocol buffer code.  DO NOT EDIT!
# source: slice.proto
#
# The JAX package's slice_pb2 descriptor, byte for byte: both packages
# register the same file, so either loads first and the wire is one.
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database

_sym_db = _symbol_database.Default()


DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x0bslice.proto\x12\x08tpuslice"T\n\x0bJoinRequest\x12\x10\n\x08hostname\x18\x01 \x01(\t\x12\x0e\n\x06coords\x18\x02 \x03(\x05\x12\x12\n\nchip_count\x18\x03 \x01(\x05\x12\x0f\n\x07session\x18\x04 \x01(\t"\xa0\x01\n\nMembership\x12\x10\n\x08slice_id\x18\x01 \x01(\t\x12\x12\n\ngeneration\x18\x02 \x01(\x03\x12\x13\n\x0bnum_workers\x18\x03 \x01(\x05\x12\x11\n\thostnames\x18\x04 \x03(\t\x12\x1b\n\x13coordinator_address\x18\x05 \x01(\t\x12\x15\n\rreshaped_from\x18\x06 \x03(\t\x12\x10\n\x08degraded\x18\x07 \x01(\x08"x\n\x0cJoinResponse\x12\x0e\n\x06formed\x18\x01 \x01(\x08\x12\x0c\n\x04rank\x18\x02 \x01(\x05\x12\x0e\n\x06joined\x18\x03 \x01(\x05\x12\x10\n\x08expected\x18\x04 \x01(\x05\x12(\n\nmembership\x18\x05 \x01(\x0b2\x14.tpuslice.Membership"Y\n\x10HeartbeatRequest\x12\x10\n\x08hostname\x18\x01 \x01(\t\x12\x0f\n\x07healthy\x18\x02 \x01(\x08\x12\x0e\n\x06reason\x18\x03 \x01(\t\x12\x12\n\ngeneration\x18\x04 \x01(\x03"q\n\x11HeartbeatResponse\x12\x15\n\rslice_healthy\x18\x01 \x01(\x08\x12\x1b\n\x13unhealthy_hostnames\x18\x02 \x03(\t\x12(\n\nmembership\x18\x03 \x01(\x0b2\x14.tpuslice.Membership2\x8e\x01\n\x0fSliceRendezvous\x125\n\x04Join\x12\x15.tpuslice.JoinRequest\x1a\x16.tpuslice.JoinResponse\x12D\n\tHeartbeat\x12\x1a.tpuslice.HeartbeatRequest\x1a\x1b.tpuslice.HeartbeatResponseb\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'slice_pb2', globals())
