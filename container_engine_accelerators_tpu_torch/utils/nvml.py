"""A small ctypes binding over NVML (`libnvidia-ml.so.1`), holding only
the calls the node layer uses: the driver version, each card's minor
number, PCI address, UUID, name and memory, and its utilisation; and
the NVLink state and error counters the fabric exporter reads
(metrics/fabric.py).

The reference reaches NVML through go-nvml plus a cgo shim for the
sample buffer (reference pkg/gpu/nvidia/metrics/util.go:17-88); ctypes
reaches `nvmlDeviceGetSamples` directly. Every call goes through a
function table, the loaded library by default, so tests drive the
binding with a fake table of Python callables that fill the ctypes
arguments as NVML would. Every return other than NVML_SUCCESS raises
NvmlError with `nvmlErrorString`'s text.
"""

from __future__ import annotations

import ctypes
import dataclasses

LIBRARY = "libnvidia-ml.so.1"

SUCCESS = 0
ERROR_INVALID_ARGUMENT = 2
ERROR_NOT_SUPPORTED = 3
ERROR_NOT_FOUND = 6
ERROR_LIBRARY_NOT_FOUND = 12

GPU_UTILIZATION_SAMPLES = 1     # nvmlSamplingType_t

NVLINK_MAX_LINKS = 18           # NVML_NVLINK_MAX_LINKS (Hopper's 18)
# nvmlNvLinkErrorCounter_t: replays, recoveries, CRC flit and data errors
# and ECC data errors of the data link layer.
NVLINK_ERROR_COUNTERS = {"dl_replay": 0, "dl_recovery": 1, "dl_crc_flit": 2,
                         "dl_crc_data": 3, "dl_ecc_data": 4}

# nvmlValueType_t -> the nvmlValue_t member it selects.
VALUE_FIELDS = {0: "dVal", 1: "uiVal", 2: "ulVal", 3: "ullVal", 4: "sllVal",
                5: "siVal", 6: "usVal"}

DRIVER_VERSION_BUFFER = 80      # NVML_SYSTEM_DRIVER_VERSION_BUFFER_SIZE
NAME_BUFFER = 96                # NVML_DEVICE_NAME_V2_BUFFER_SIZE
UUID_BUFFER = 96                # NVML_DEVICE_UUID_V2_BUFFER_SIZE


class PciInfo(ctypes.Structure):
    """nvmlPciInfo_t, the layout nvmlDeviceGetPciInfo_v3 fills."""
    _fields_ = [("busIdLegacy", ctypes.c_char * 16),
                ("domain", ctypes.c_uint),
                ("bus", ctypes.c_uint),
                ("device", ctypes.c_uint),
                ("pciDeviceId", ctypes.c_uint),
                ("pciSubSystemId", ctypes.c_uint),
                ("busId", ctypes.c_char * 32)]


class Memory(ctypes.Structure):
    """nvmlMemory_t."""
    _fields_ = [("total", ctypes.c_ulonglong),
                ("free", ctypes.c_ulonglong),
                ("used", ctypes.c_ulonglong)]


class Utilization(ctypes.Structure):
    """nvmlUtilization_t."""
    _fields_ = [("gpu", ctypes.c_uint), ("memory", ctypes.c_uint)]


class Value(ctypes.Union):
    """nvmlValue_t."""
    _fields_ = [("dVal", ctypes.c_double), ("siVal", ctypes.c_int),
                ("uiVal", ctypes.c_uint), ("ulVal", ctypes.c_ulong),
                ("ullVal", ctypes.c_ulonglong),
                ("sllVal", ctypes.c_longlong), ("usVal", ctypes.c_ushort)]


class Sample(ctypes.Structure):
    """nvmlSample_t."""
    _fields_ = [("timeStamp", ctypes.c_ulonglong), ("sampleValue", Value)]


_P = ctypes.POINTER
_HANDLE = ctypes.c_void_p       # nvmlDevice_t
SIGNATURES = {
    "nvmlInit_v2": [],
    "nvmlShutdown": [],
    "nvmlSystemGetDriverVersion": [ctypes.c_char_p, ctypes.c_uint],
    "nvmlDeviceGetCount_v2": [_P(ctypes.c_uint)],
    "nvmlDeviceGetHandleByIndex_v2": [ctypes.c_uint, _P(_HANDLE)],
    "nvmlDeviceGetMinorNumber": [_HANDLE, _P(ctypes.c_uint)],
    "nvmlDeviceGetPciInfo_v3": [_HANDLE, _P(PciInfo)],
    "nvmlDeviceGetUUID": [_HANDLE, ctypes.c_char_p, ctypes.c_uint],
    "nvmlDeviceGetName": [_HANDLE, ctypes.c_char_p, ctypes.c_uint],
    "nvmlDeviceGetMemoryInfo": [_HANDLE, _P(Memory)],
    "nvmlDeviceGetSamples": [_HANDLE, ctypes.c_int, ctypes.c_ulonglong,
                             _P(ctypes.c_int), _P(ctypes.c_uint),
                             _P(Sample)],
    "nvmlDeviceGetUtilizationRates": [_HANDLE, _P(Utilization)],
    "nvmlDeviceGetNvLinkState": [_HANDLE, ctypes.c_uint, _P(ctypes.c_int)],
    "nvmlDeviceGetNvLinkErrorCounter": [_HANDLE, ctypes.c_uint, ctypes.c_int,
                                        _P(ctypes.c_ulonglong)],
}


class NvmlError(RuntimeError):
    """A call that NVML refused: its return code and NVML's text."""

    def __init__(self, code: int, text: str, call: str = ""):
        super().__init__(f"{call}: {text} (NVML error {code})" if call
                         else f"{text} (NVML error {code})")
        self.code = code
        self.text = text


@dataclasses.dataclass(frozen=True)
class CardIdentity:
    """One card as NVML names it. pci_address is in sysfs's form
    (0000:18:00.0), or None where NVML does not report it."""
    index: int
    minor: int
    pci_address: str | None
    uuid: str
    name: str


def sysfs_pci_address(bus_id: str) -> str:
    """NVML's bus ID ('00000000:18:00.0') in sysfs's form
    ('0000:18:00.0')."""
    domain, _, rest = bus_id.partition(":")
    return f"{int(domain, 16):04x}:{rest.lower()}"


def load_library(path: str | None = None):
    """The NVML library (`path`, or LIBRARY) with every bound call's
    argtypes and restype declared. Raises NvmlError
    (NVML_ERROR_LIBRARY_NOT_FOUND) where it cannot be loaded."""
    try:
        lib = ctypes.CDLL(path or LIBRARY)
    except OSError as e:
        raise NvmlError(ERROR_LIBRARY_NOT_FOUND,
                        f"NVML Shared Library Not Found ({e})") from None
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.nvmlErrorString.argtypes = [ctypes.c_int]
    lib.nvmlErrorString.restype = ctypes.c_char_p
    return lib


class Nvml:
    """An initialised NVML session over `table`: the loaded library, or
    any object with the bound functions and `nvmlErrorString`. close()
    shuts the session down."""

    def __init__(self, table=None):
        self.table = table if table is not None else load_library()
        self._call("nvmlInit_v2")
        self._closed = False

    def close(self) -> None:
        if not self._closed:
            self._closed = True
            self._call("nvmlShutdown")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def _call(self, name: str, *args) -> None:
        rc = getattr(self.table, name)(*args)
        if rc != SUCCESS:
            text = self.table.nvmlErrorString(rc)
            if isinstance(text, bytes):
                text = text.decode(errors="replace")
            raise NvmlError(rc, text or "Unknown Error", name)

    def _string(self, name: str, size: int, *head) -> str:
        buf = ctypes.create_string_buffer(size)
        self._call(name, *head, buf, size)
        return buf.value.decode(errors="replace")

    # ---------- system ----------

    def driver_version(self) -> str:
        return self._string("nvmlSystemGetDriverVersion",
                            DRIVER_VERSION_BUFFER)

    def device_count(self) -> int:
        n = ctypes.c_uint()
        self._call("nvmlDeviceGetCount_v2", ctypes.byref(n))
        return n.value

    # ---------- one device ----------

    def handle(self, index: int):
        h = _HANDLE()
        self._call("nvmlDeviceGetHandleByIndex_v2", index, ctypes.byref(h))
        return h

    def minor_number(self, handle) -> int:
        m = ctypes.c_uint()
        self._call("nvmlDeviceGetMinorNumber", handle, ctypes.byref(m))
        return m.value

    def pci_bus_id(self, handle) -> str:
        info = PciInfo()
        self._call("nvmlDeviceGetPciInfo_v3", handle, ctypes.byref(info))
        return info.busId.decode(errors="replace")

    def uuid(self, handle) -> str:
        return self._string("nvmlDeviceGetUUID", UUID_BUFFER, handle)

    def name(self, handle) -> str:
        return self._string("nvmlDeviceGetName", NAME_BUFFER, handle)

    def memory_info(self, handle) -> tuple[int, int, int]:
        """(total, free, used) bytes of device memory."""
        mem = Memory()
        self._call("nvmlDeviceGetMemoryInfo", handle, ctypes.byref(mem))
        return mem.total, mem.free, mem.used

    def utilization_rates(self, handle) -> tuple[int, int]:
        """(gpu, memory) percent over NVML's last sample period."""
        util = Utilization()
        self._call("nvmlDeviceGetUtilizationRates", handle,
                   ctypes.byref(util))
        return util.gpu, util.memory

    def nvlink_active(self, handle, link: int) -> bool:
        """Whether `link` is up (nvmlDeviceGetNvLinkState)."""
        state = ctypes.c_int()
        self._call("nvmlDeviceGetNvLinkState", handle, link,
                   ctypes.byref(state))
        return bool(state.value)

    def nvlink_error_counter(self, handle, link: int, counter: int) -> int:
        """One of `link`'s error counters (NVLINK_ERROR_COUNTERS)."""
        value = ctypes.c_ulonglong()
        self._call("nvmlDeviceGetNvLinkErrorCounter", handle, link, counter,
                   ctypes.byref(value))
        return value.value

    def nvlink_errors(self, handle) -> int:
        """The sum of every error counter of every active link. Raises
        NvmlError where NVML does not answer for the card (Not Supported
        on a card without NVLink, or where the driver keeps the counters
        from the process); a link past the card's last is the end of
        the walk."""
        total, any_link = 0, False
        for link in range(NVLINK_MAX_LINKS):
            try:
                active = self.nvlink_active(handle, link)
            except NvmlError as e:
                if e.code == ERROR_INVALID_ARGUMENT and any_link:
                    break
                raise
            any_link = True
            if not active:
                continue
            for counter in NVLINK_ERROR_COUNTERS.values():
                total += self.nvlink_error_counter(handle, link, counter)
        return total

    def samples(self, handle, sampling_type: int,
                last_seen_us: int) -> list[tuple[int, float]]:
        """(timestamp in microseconds, value) of each buffered sample
        newer than `last_seen_us`: one call for the count, one for the
        samples (the reference's nvmlDeviceGetAverageUsage shim)."""
        value_type, count = ctypes.c_int(), ctypes.c_uint()
        self._call("nvmlDeviceGetSamples", handle, sampling_type,
                   last_seen_us, ctypes.byref(value_type),
                   ctypes.byref(count), None)
        if count.value == 0:
            return []
        buf = (Sample * count.value)()
        self._call("nvmlDeviceGetSamples", handle, sampling_type,
                   last_seen_us, ctypes.byref(value_type),
                   ctypes.byref(count), buf)
        field = VALUE_FIELDS.get(value_type.value, "uiVal")
        return [(s.timeStamp, float(getattr(s.sampleValue, field)))
                for s in buf[:count.value]]

    # ---------- enumeration ----------

    def cards(self) -> dict[int, CardIdentity]:
        """Every card NVML enumerates for this process, keyed by minor
        number. A PCI address NVML does not support reading is None."""
        out = {}
        for index in range(self.device_count()):
            h = self.handle(index)
            minor = self.minor_number(h)
            try:
                pci = sysfs_pci_address(self.pci_bus_id(h))
            except NvmlError as e:
                if e.code != ERROR_NOT_SUPPORTED:
                    raise
                pci = None
            out[minor] = CardIdentity(index=index, minor=minor,
                                      pci_address=pci, uuid=self.uuid(h),
                                      name=self.name(h))
        return out

    def handle_by_minor(self, minor: int):
        """The handle whose minor number is `minor`; raises NvmlError
        (NVML_ERROR_NOT_FOUND) where no card NVML enumerates has it."""
        for index in range(self.device_count()):
            h = self.handle(index)
            if self.minor_number(h) == minor:
                return h
        raise NvmlError(ERROR_NOT_FOUND, "Not Found",
                        f"no card with minor number {minor}")

