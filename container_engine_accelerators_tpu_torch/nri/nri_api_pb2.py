# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: nri_api.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\rnri_api.proto\x12\x14nri.pkg.api.v1alpha1\"\x07\n\x05\x45mpty\"@\n\x15RegisterPluginRequest\x12\x13\n\x0bplugin_name\x18\x01 \x01(\t\x12\x12\n\nplugin_idx\x18\x02 \x01(\t\"Q\n\x10\x43onfigureRequest\x12\x0e\n\x06\x63onfig\x18\x01 \x01(\t\x12\x14\n\x0cruntime_name\x18\x02 \x01(\t\x12\x17\n\x0fruntime_version\x18\x03 \x01(\t\"#\n\x11\x43onfigureResponse\x12\x0e\n\x06\x65vents\x18\x02 \x01(\x05\"y\n\x12SynchronizeRequest\x12.\n\x04pods\x18\x01 \x03(\x0b\x32 .nri.pkg.api.v1alpha1.PodSandbox\x12\x33\n\ncontainers\x18\x02 \x03(\x0b\x32\x1f.nri.pkg.api.v1alpha1.Container\"L\n\x13SynchronizeResponse\x12\x35\n\x06update\x18\x01 \x03(\x0b\x32%.nri.pkg.api.v1alpha1.ContainerUpdate\"{\n\x16\x43reateContainerRequest\x12-\n\x03pod\x18\x01 \x01(\x0b\x32 .nri.pkg.api.v1alpha1.PodSandbox\x12\x32\n\tcontainer\x18\x02 \x01(\x0b\x32\x1f.nri.pkg.api.v1alpha1.Container\"\x8b\x01\n\x17\x43reateContainerResponse\x12\x39\n\x06\x61\x64just\x18\x01 \x01(\x0b\x32).nri.pkg.api.v1alpha1.ContainerAdjustment\x12\x35\n\x06update\x18\x02 \x03(\x0b\x32%.nri.pkg.api.v1alpha1.ContainerUpdate\"\x84\x01\n\x10StateChangeEvent\x12\r\n\x05\x65vent\x18\x01 \x01(\x05\x12-\n\x03pod\x18\x02 \x01(\x0b\x32 .nri.pkg.api.v1alpha1.PodSandbox\x12\x32\n\tcontainer\x18\x03 \x01(\x0b\x32\x1f.nri.pkg.api.v1alpha1.Container\"\xaf\x02\n\nPodSandbox\x12\n\n\x02id\x18\x01 \x01(\t\x12\x0c\n\x04name\x18\x02 \x01(\t\x12\x0b\n\x03uid\x18\x03 \x01(\t\x12\x11\n\tnamespace\x18\x04 \x01(\t\x12<\n\x06labels\x18\x05 \x03(\x0b\x32,.nri.pkg.api.v1alpha1.PodSandbox.LabelsEntry\x12\x46\n\x0b\x61nnotations\x18\x06 \x03(\x0b\x32\x31.nri.pkg.api.v1alpha1.PodSandbox.AnnotationsEntry\x1a-\n\x0bLabelsEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\t:\x02\x38\x01\x1a\x32\n\x10\x41nnotationsEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\t:\x02\x38\x01\"\xa4\x02\n\tContainer\x12\n\n\x02id\x18\x01 \x01(\t\x12\x16\n\x0epod_sandbox_id\x18\x02 \x01(\t\x12\x0c\n\x04name\x18\x03 \x01(\t\x12;\n\x06labels\x18\x05 \x03(\x0b\x32+.nri.pkg.api.v1alpha1.Container.LabelsEntry\x12\x45\n\x0b\x61nnotations\x18\x06 \x03(\x0b\x32\x30.nri.pkg.api.v1alpha1.Container.AnnotationsEntry\x1a-\n\x0bLabelsEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\t:\x02\x38\x01\x1a\x32\n\x10\x41nnotationsEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\t:\x02\x38\x01\"z\n\x0f\x43ontainerUpdate\x12\x14\n\x0c\x63ontainer_id\x18\x01 \x01(\t\x12\x39\n\x05linux\x18\x02 \x01(\x0b\x32*.nri.pkg.api.v1alpha1.LinuxContainerUpdate\x12\x16\n\x0eignore_failure\x18\x03 \x01(\x08\"O\n\x14LinuxContainerUpdate\x12\x37\n\tresources\x18\x01 \x01(\x0b\x32$.nri.pkg.api.v1alpha1.LinuxResources\"p\n\x0eLinuxResources\x12\x31\n\x06memory\x18\x01 \x01(\x0b\x32!.nri.pkg.api.v1alpha1.LinuxMemory\x12+\n\x03\x63pu\x18\x02 \x01(\x0b\x32\x1e.nri.pkg.api.v1alpha1.LinuxCPU\"A\n\x0bLinuxMemory\x12\x32\n\x05limit\x18\x01 \x01(\x0b\x32#.nri.pkg.api.v1alpha1.OptionalInt64\"\xaa\x01\n\x08LinuxCPU\x12\x34\n\x06shares\x18\x01 \x01(\x0b\x32$.nri.pkg.api.v1alpha1.OptionalUInt64\x12\x32\n\x05quota\x18\x02 \x01(\x0b\x32#.nri.pkg.api.v1alpha1.OptionalInt64\x12\x34\n\x06period\x18\x03 \x01(\x0b\x32$.nri.pkg.api.v1alpha1.OptionalUInt64\"\x1e\n\rOptionalInt64\x12\r\n\x05value\x18\x01 \x01(\x03\"P\n\x17UpdateContainersRequest\x12\x35\n\x06update\x18\x01 \x03(\x0b\x32%.nri.pkg.api.v1alpha1.ContainerUpdate\"Q\n\x18UpdateContainersResponse\x12\x35\n\x06\x66\x61iled\x18\x01 \x03(\x0b\x32%.nri.pkg.api.v1alpha1.ContainerUpdate\"\x1f\n\x0eOptionalUInt64\x12\r\n\x05value\x18\x01 \x01(\x04\"\xd9\x01\n\x13\x43ontainerAdjustment\x12O\n\x0b\x61nnotations\x18\x02 \x03(\x0b\x32:.nri.pkg.api.v1alpha1.ContainerAdjustment.AnnotationsEntry\x12=\n\x05linux\x18\x06 \x01(\x0b\x32..nri.pkg.api.v1alpha1.LinuxContainerAdjustment\x1a\x32\n\x10\x41nnotationsEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\t:\x02\x38\x01\"N\n\x18LinuxContainerAdjustment\x12\x32\n\x07\x64\x65vices\x18\x01 \x03(\x0b\x32!.nri.pkg.api.v1alpha1.LinuxDevice\"\xe8\x01\n\x0bLinuxDevice\x12\x0c\n\x04path\x18\x01 \x01(\t\x12\x0c\n\x04type\x18\x02 \x01(\t\x12\r\n\x05major\x18\x03 \x01(\x03\x12\r\n\x05minor\x18\x04 \x01(\x03\x12\x39\n\tfile_mode\x18\x05 \x01(\x0b\x32&.nri.pkg.api.v1alpha1.OptionalFileMode\x12\x31\n\x03uid\x18\x06 \x01(\x0b\x32$.nri.pkg.api.v1alpha1.OptionalUInt32\x12\x31\n\x03gid\x18\x07 \x01(\x0b\x32$.nri.pkg.api.v1alpha1.OptionalUInt32\"!\n\x10OptionalFileMode\x12\r\n\x05value\x18\x01 \x01(\r\"\x1f\n\x0eOptionalUInt32\x12\r\n\x05value\x18\x01 \x01(\rb\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'nri_api_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _PODSANDBOX_LABELSENTRY._options = None
  _PODSANDBOX_LABELSENTRY._serialized_options = b'8\001'
  _PODSANDBOX_ANNOTATIONSENTRY._options = None
  _PODSANDBOX_ANNOTATIONSENTRY._serialized_options = b'8\001'
  _CONTAINER_LABELSENTRY._options = None
  _CONTAINER_LABELSENTRY._serialized_options = b'8\001'
  _CONTAINER_ANNOTATIONSENTRY._options = None
  _CONTAINER_ANNOTATIONSENTRY._serialized_options = b'8\001'
  _CONTAINERADJUSTMENT_ANNOTATIONSENTRY._options = None
  _CONTAINERADJUSTMENT_ANNOTATIONSENTRY._serialized_options = b'8\001'
  _EMPTY._serialized_start=39
  _EMPTY._serialized_end=46
  _REGISTERPLUGINREQUEST._serialized_start=48
  _REGISTERPLUGINREQUEST._serialized_end=112
  _CONFIGUREREQUEST._serialized_start=114
  _CONFIGUREREQUEST._serialized_end=195
  _CONFIGURERESPONSE._serialized_start=197
  _CONFIGURERESPONSE._serialized_end=232
  _SYNCHRONIZEREQUEST._serialized_start=234
  _SYNCHRONIZEREQUEST._serialized_end=355
  _SYNCHRONIZERESPONSE._serialized_start=357
  _SYNCHRONIZERESPONSE._serialized_end=433
  _CREATECONTAINERREQUEST._serialized_start=435
  _CREATECONTAINERREQUEST._serialized_end=558
  _CREATECONTAINERRESPONSE._serialized_start=561
  _CREATECONTAINERRESPONSE._serialized_end=700
  _STATECHANGEEVENT._serialized_start=703
  _STATECHANGEEVENT._serialized_end=835
  _PODSANDBOX._serialized_start=838
  _PODSANDBOX._serialized_end=1141
  _PODSANDBOX_LABELSENTRY._serialized_start=1044
  _PODSANDBOX_LABELSENTRY._serialized_end=1089
  _PODSANDBOX_ANNOTATIONSENTRY._serialized_start=1091
  _PODSANDBOX_ANNOTATIONSENTRY._serialized_end=1141
  _CONTAINER._serialized_start=1144
  _CONTAINER._serialized_end=1436
  _CONTAINER_LABELSENTRY._serialized_start=1044
  _CONTAINER_LABELSENTRY._serialized_end=1089
  _CONTAINER_ANNOTATIONSENTRY._serialized_start=1091
  _CONTAINER_ANNOTATIONSENTRY._serialized_end=1141
  _CONTAINERUPDATE._serialized_start=1438
  _CONTAINERUPDATE._serialized_end=1560
  _LINUXCONTAINERUPDATE._serialized_start=1562
  _LINUXCONTAINERUPDATE._serialized_end=1641
  _LINUXRESOURCES._serialized_start=1643
  _LINUXRESOURCES._serialized_end=1755
  _LINUXMEMORY._serialized_start=1757
  _LINUXMEMORY._serialized_end=1822
  _LINUXCPU._serialized_start=1825
  _LINUXCPU._serialized_end=1995
  _OPTIONALINT64._serialized_start=1997
  _OPTIONALINT64._serialized_end=2027
  _UPDATECONTAINERSREQUEST._serialized_start=2029
  _UPDATECONTAINERSREQUEST._serialized_end=2109
  _UPDATECONTAINERSRESPONSE._serialized_start=2111
  _UPDATECONTAINERSRESPONSE._serialized_end=2192
  _OPTIONALUINT64._serialized_start=2194
  _OPTIONALUINT64._serialized_end=2225
  _CONTAINERADJUSTMENT._serialized_start=2228
  _CONTAINERADJUSTMENT._serialized_end=2445
  _CONTAINERADJUSTMENT_ANNOTATIONSENTRY._serialized_start=1091
  _CONTAINERADJUSTMENT_ANNOTATIONSENTRY._serialized_end=1141
  _LINUXCONTAINERADJUSTMENT._serialized_start=2447
  _LINUXCONTAINERADJUSTMENT._serialized_end=2525
  _LINUXDEVICE._serialized_start=2528
  _LINUXDEVICE._serialized_end=2760
  _OPTIONALFILEMODE._serialized_start=2762
  _OPTIONALFILEMODE._serialized_end=2795
  _OPTIONALUINT32._serialized_start=2797
  _OPTIONALUINT32._serialized_end=2828
# @@protoc_insertion_point(module_scope)
