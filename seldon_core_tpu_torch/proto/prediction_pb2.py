# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: prediction.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()


from google.protobuf import struct_pb2 as google_dot_protobuf_dot_struct__pb2


DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x10prediction.proto\x12\nseldon.tpu\x1a\x1cgoogle/protobuf/struct.proto\"7\n\x06Tensor\x12\r\n\x05\x64type\x18\x01 \x01(\t\x12\x11\n\x05shape\x18\x02 \x03(\x03\x42\x02\x10\x01\x12\x0b\n\x03raw\x18\x03 \x01(\x0c\"5\n\x0cLegacyTensor\x12\x11\n\x05shape\x18\x01 \x03(\x05\x42\x02\x10\x01\x12\x12\n\x06values\x18\x02 \x03(\x01\x42\x02\x10\x01\"Z\n\x0f\x44\x65viceTensorRef\x12\x13\n\x0b\x62uffer_uuid\x18\x01 \x01(\t\x12\r\n\x05\x64type\x18\x02 \x01(\t\x12\x11\n\x05shape\x18\x03 \x03(\x03\x42\x02\x10\x01\x12\x10\n\x08sharding\x18\x04 \x01(\t\"\xdd\x01\n\x0b\x44\x65\x66\x61ultData\x12\r\n\x05names\x18\x01 \x03(\t\x12*\n\x06tensor\x18\x02 \x01(\x0b\x32\x18.seldon.tpu.LegacyTensorH\x00\x12-\n\x07ndarray\x18\x03 \x01(\x0b\x32\x1a.google.protobuf.ListValueH\x00\x12\'\n\tbinTensor\x18\x04 \x01(\x0b\x32\x12.seldon.tpu.TensorH\x00\x12-\n\x06\x64\x65vice\x18\x05 \x01(\x0b\x32\x1b.seldon.tpu.DeviceTensorRefH\x00\x42\x0c\n\ndata_oneof\"\xdb\x01\n\x06Metric\x12\x0b\n\x03key\x18\x01 \x01(\t\x12+\n\x04type\x18\x02 \x01(\x0e\x32\x1d.seldon.tpu.Metric.MetricType\x12\r\n\x05value\x18\x03 \x01(\x02\x12*\n\x04tags\x18\x04 \x03(\x0b\x32\x1c.seldon.tpu.Metric.TagsEntry\x1a+\n\tTagsEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\t:\x02\x38\x01\"/\n\nMetricType\x12\x0b\n\x07\x43OUNTER\x10\x00\x12\t\n\x05GAUGE\x10\x01\x12\t\n\x05TIMER\x10\x02\"\xf4\x02\n\x04Meta\x12\x0c\n\x04puid\x18\x01 \x01(\t\x12(\n\x04tags\x18\x02 \x03(\x0b\x32\x1a.seldon.tpu.Meta.TagsEntry\x12.\n\x07routing\x18\x03 \x03(\x0b\x32\x1d.seldon.tpu.Meta.RoutingEntry\x12\x36\n\x0brequestPath\x18\x04 \x03(\x0b\x32!.seldon.tpu.Meta.RequestPathEntry\x12#\n\x07metrics\x18\x05 \x03(\x0b\x32\x12.seldon.tpu.Metric\x1a\x43\n\tTagsEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12%\n\x05value\x18\x02 \x01(\x0b\x32\x16.google.protobuf.Value:\x02\x38\x01\x1a.\n\x0cRoutingEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\x05:\x02\x38\x01\x1a\x32\n\x10RequestPathEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\t:\x02\x38\x01\"\x8b\x01\n\x06Status\x12\x0c\n\x04\x63ode\x18\x01 \x01(\x05\x12\x0c\n\x04info\x18\x02 \x01(\t\x12\x0e\n\x06reason\x18\x03 \x01(\t\x12-\n\x06status\x18\x04 \x01(\x0e\x32\x1d.seldon.tpu.Status.StatusFlag\"&\n\nStatusFlag\x12\x0b\n\x07SUCCESS\x10\x00\x12\x0b\n\x07\x46\x41ILURE\x10\x01\"\xdc\x01\n\rSeldonMessage\x12\"\n\x06status\x18\x01 \x01(\x0b\x32\x12.seldon.tpu.Status\x12\x1e\n\x04meta\x18\x02 \x01(\x0b\x32\x10.seldon.tpu.Meta\x12\'\n\x04\x64\x61ta\x18\x03 \x01(\x0b\x32\x17.seldon.tpu.DefaultDataH\x00\x12\x11\n\x07\x62inData\x18\x04 \x01(\x0cH\x00\x12\x11\n\x07strData\x18\x05 \x01(\tH\x00\x12*\n\x08jsonData\x18\x06 \x01(\x0b\x32\x16.google.protobuf.ValueH\x00\x42\x0c\n\ndata_oneof\"F\n\x11SeldonMessageList\x12\x31\n\x0eseldonMessages\x18\x01 \x03(\x0b\x32\x19.seldon.tpu.SeldonMessage\"\x9d\x01\n\x08\x46\x65\x65\x64\x62\x61\x63k\x12*\n\x07request\x18\x01 \x01(\x0b\x32\x19.seldon.tpu.SeldonMessage\x12+\n\x08response\x18\x02 \x01(\x0b\x32\x19.seldon.tpu.SeldonMessage\x12\x0e\n\x06reward\x18\x03 \x01(\x02\x12(\n\x05truth\x18\x04 \x01(\x0b\x32\x19.seldon.tpu.SeldonMessage\"j\n\x0fRequestResponse\x12*\n\x07request\x18\x01 \x01(\x0b\x32\x19.seldon.tpu.SeldonMessage\x12+\n\x08response\x18\x02 \x01(\x0b\x32\x19.seldon.tpu.SeldonMessage2\xe1\x02\n\x07Generic\x12\x46\n\x0eTransformInput\x12\x19.seldon.tpu.SeldonMessage\x1a\x19.seldon.tpu.SeldonMessage\x12G\n\x0fTransformOutput\x12\x19.seldon.tpu.SeldonMessage\x1a\x19.seldon.tpu.SeldonMessage\x12=\n\x05Route\x12\x19.seldon.tpu.SeldonMessage\x1a\x19.seldon.tpu.SeldonMessage\x12\x45\n\tAggregate\x12\x1d.seldon.tpu.SeldonMessageList\x1a\x19.seldon.tpu.SeldonMessage\x12?\n\x0cSendFeedback\x12\x14.seldon.tpu.Feedback\x1a\x19.seldon.tpu.SeldonMessage2\x89\x01\n\x05Model\x12?\n\x07Predict\x12\x19.seldon.tpu.SeldonMessage\x1a\x19.seldon.tpu.SeldonMessage\x12?\n\x0cSendFeedback\x12\x14.seldon.tpu.Feedback\x1a\x19.seldon.tpu.SeldonMessage2\x88\x01\n\x06Router\x12=\n\x05Route\x12\x19.seldon.tpu.SeldonMessage\x1a\x19.seldon.tpu.SeldonMessage\x12?\n\x0cSendFeedback\x12\x14.seldon.tpu.Feedback\x1a\x19.seldon.tpu.SeldonMessage2U\n\x0bTransformer\x12\x46\n\x0eTransformInput\x12\x19.seldon.tpu.SeldonMessage\x1a\x19.seldon.tpu.SeldonMessage2\\\n\x11OutputTransformer\x12G\n\x0fTransformOutput\x12\x19.seldon.tpu.SeldonMessage\x1a\x19.seldon.tpu.SeldonMessage2Q\n\x08\x43ombiner\x12\x45\n\tAggregate\x12\x1d.seldon.tpu.SeldonMessageList\x1a\x19.seldon.tpu.SeldonMessage2\x8a\x01\n\x06Seldon\x12?\n\x07Predict\x12\x19.seldon.tpu.SeldonMessage\x1a\x19.seldon.tpu.SeldonMessage\x12?\n\x0cSendFeedback\x12\x14.seldon.tpu.Feedback\x1a\x19.seldon.tpu.SeldonMessageb\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'prediction_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _TENSOR.fields_by_name['shape']._options = None
  _TENSOR.fields_by_name['shape']._serialized_options = b'\020\001'
  _LEGACYTENSOR.fields_by_name['shape']._options = None
  _LEGACYTENSOR.fields_by_name['shape']._serialized_options = b'\020\001'
  _LEGACYTENSOR.fields_by_name['values']._options = None
  _LEGACYTENSOR.fields_by_name['values']._serialized_options = b'\020\001'
  _DEVICETENSORREF.fields_by_name['shape']._options = None
  _DEVICETENSORREF.fields_by_name['shape']._serialized_options = b'\020\001'
  _METRIC_TAGSENTRY._options = None
  _METRIC_TAGSENTRY._serialized_options = b'8\001'
  _META_TAGSENTRY._options = None
  _META_TAGSENTRY._serialized_options = b'8\001'
  _META_ROUTINGENTRY._options = None
  _META_ROUTINGENTRY._serialized_options = b'8\001'
  _META_REQUESTPATHENTRY._options = None
  _META_REQUESTPATHENTRY._serialized_options = b'8\001'
  _TENSOR._serialized_start=62
  _TENSOR._serialized_end=117
  _LEGACYTENSOR._serialized_start=119
  _LEGACYTENSOR._serialized_end=172
  _DEVICETENSORREF._serialized_start=174
  _DEVICETENSORREF._serialized_end=264
  _DEFAULTDATA._serialized_start=267
  _DEFAULTDATA._serialized_end=488
  _METRIC._serialized_start=491
  _METRIC._serialized_end=710
  _METRIC_TAGSENTRY._serialized_start=618
  _METRIC_TAGSENTRY._serialized_end=661
  _METRIC_METRICTYPE._serialized_start=663
  _METRIC_METRICTYPE._serialized_end=710
  _META._serialized_start=713
  _META._serialized_end=1085
  _META_TAGSENTRY._serialized_start=918
  _META_TAGSENTRY._serialized_end=985
  _META_ROUTINGENTRY._serialized_start=987
  _META_ROUTINGENTRY._serialized_end=1033
  _META_REQUESTPATHENTRY._serialized_start=1035
  _META_REQUESTPATHENTRY._serialized_end=1085
  _STATUS._serialized_start=1088
  _STATUS._serialized_end=1227
  _STATUS_STATUSFLAG._serialized_start=1189
  _STATUS_STATUSFLAG._serialized_end=1227
  _SELDONMESSAGE._serialized_start=1230
  _SELDONMESSAGE._serialized_end=1450
  _SELDONMESSAGELIST._serialized_start=1452
  _SELDONMESSAGELIST._serialized_end=1522
  _FEEDBACK._serialized_start=1525
  _FEEDBACK._serialized_end=1682
  _REQUESTRESPONSE._serialized_start=1684
  _REQUESTRESPONSE._serialized_end=1790
  _GENERIC._serialized_start=1793
  _GENERIC._serialized_end=2146
  _MODEL._serialized_start=2149
  _MODEL._serialized_end=2286
  _ROUTER._serialized_start=2289
  _ROUTER._serialized_end=2425
  _TRANSFORMER._serialized_start=2427
  _TRANSFORMER._serialized_end=2512
  _OUTPUTTRANSFORMER._serialized_start=2514
  _OUTPUTTRANSFORMER._serialized_end=2606
  _COMBINER._serialized_start=2608
  _COMBINER._serialized_end=2689
  _SELDON._serialized_start=2692
  _SELDON._serialized_end=2830
# @@protoc_insertion_point(module_scope)
