"""The port's NRI device injector (nri/) against the JAX package's: the
annotation contract and the device stat through both packages, the
port's frames against the JAX package's golden bytes, the two packages
talking to each other over one socket, and the port's plugin end to end
against a fake runtime. The nodes are the card's (/dev/nvidia<N>,
/dev/nvidiactl, /dev/nvidia-uvm); /dev/null (char 1, 3) stands in for a
device node where no root is needed to make one."""

import importlib
import os
import socket
import stat
import struct
import threading

import pytest

from tests.test_nri_golden import (
    EMPTY_RESPONSE,
    REGISTER_INNER,
    REGISTER_REQUEST,
    field_bytes,
    mux_frame,
    ttrpc_frame,
)

PACKAGES = {"jax": "container_engine_accelerators_tpu",
            "torch": "container_engine_accelerators_tpu_torch"}
needs_root = pytest.mark.skipif(os.getuid() != 0, reason="needs root (mknod)")
# The nodes the port's Allocate returns for card 0, with the driver's
# numbers: nvidia<N> and nvidiactl on major 195, nvidia-uvm on its own.
NVIDIA_NODES = {"nvidia0": (195, 0), "nvidiactl": (195, 255),
                "nvidia-uvm": (511, 0)}


def nri(pkg: str, module: str = ""):
    return importlib.import_module(
        f"{PACKAGES[pkg]}.nri{'.' + module if module else ''}")


@pytest.fixture(params=sorted(PACKAGES))
def pkg(request):
    return request.param


def _mknod_nvidia(tmp_path) -> dict:
    paths = {}
    for name, (major, minor) in NVIDIA_NODES.items():
        path = tmp_path / name
        os.mknod(str(path), 0o666 | stat.S_IFCHR, os.makedev(major, minor))
        paths[name] = str(path)
    return paths


# ---------- annotations and the device stat, both packages ----------

def test_parse_annotations(pkg):
    n = nri(pkg)
    ann = {n.ANNOTATION_PREFIX + "sidecar":
           "- path: /dev/nvidia0\n- path: /dev/nvidiactl\n"
           "- path: /dev/nvidia-uvm\n",
           "unrelated/annotation": "x"}
    assert n.parse_device_annotations(ann) == {
        "sidecar": ["/dev/nvidia0", "/dev/nvidiactl", "/dev/nvidia-uvm"]}


@pytest.mark.parametrize("bad", ["not a list", "- nopath: /dev/x", "{}"])
def test_parse_annotations_malformed(pkg, bad):
    n = nri(pkg)
    with pytest.raises(ValueError) as err:
        n.parse_device_annotations({n.ANNOTATION_PREFIX + "c": bad})
    other = nri({"jax": "torch", "torch": "jax"}[pkg])
    with pytest.raises(ValueError) as err_other:
        other.parse_device_annotations({other.ANNOTATION_PREFIX + "c": bad})
    assert str(err.value) == str(err_other.value)


def test_parse_annotations_empty_container_name(pkg):
    n = nri(pkg)
    with pytest.raises(ValueError):
        n.parse_device_annotations({n.ANNOTATION_PREFIX: "- path: /dev/x"})


def test_to_nri_device_rejects_regular_file(pkg, tmp_path):
    f = tmp_path / "plain"
    f.touch()
    with pytest.raises(ValueError, match="not a device node"):
        nri(pkg).to_nri_device(str(f))


def test_to_nri_device_reads_dev_null(pkg):
    dev = nri(pkg).to_nri_device("/dev/null")
    st = os.stat("/dev/null")
    assert (dev.type, dev.major, dev.minor) == ("c", 1, 3)
    assert (dev.uid, dev.gid) == (st.st_uid, st.st_gid)
    assert dev.as_nri() == nri("jax").to_nri_device("/dev/null").as_nri()


@needs_root
def test_to_nri_device_char_node(pkg, tmp_path):
    node = tmp_path / "nvidia7"
    os.mknod(str(node), 0o600 | stat.S_IFCHR, os.makedev(195, 7))
    dev = nri(pkg).to_nri_device(str(node))
    assert dev.type == "c"
    assert (dev.major, dev.minor) == (195, 7)
    assert dev.as_nri()["path"] == str(node)


@needs_root
def test_devices_for_container_end_to_end(pkg, tmp_path):
    n = nri(pkg)
    paths = _mknod_nvidia(tmp_path)
    ann = {n.ANNOTATION_PREFIX + "rxdm":
           "".join(f"- path: {p}\n" for p in paths.values())}
    devs = n.devices_for_container(ann, "rxdm")
    assert [(d.major, d.minor) for d in devs] == list(NVIDIA_NODES.values())
    assert n.devices_for_container(ann, "other") == []
    adjustments = n.inject_for_pod(ann)
    assert list(adjustments) == ["rxdm"]
    assert adjustments == nri("jax").inject_for_pod(ann)


def test_devices_for_container_missing_node(pkg, tmp_path):
    n = nri(pkg)
    ann = {n.ANNOTATION_PREFIX + "c": f"- path: {tmp_path}/nvidia9\n"}
    with pytest.raises(ValueError, match="cannot inject"):
        n.devices_for_container(ann, "c")


# ---------- the port's frames against the golden bytes ----------

def test_port_protobuf_encoding_matches_spec_bytes():
    api = nri("torch", "nri_api_pb2")
    tpb = nri("torch", "ttrpc_messages_pb2")
    assert api.RegisterPluginRequest(
        plugin_name="tpu-device-injector",
        plugin_idx="10").SerializeToString() == REGISTER_INNER
    assert tpb.Request(service="nri.pkg.api.v1alpha1.Runtime",
                       method="RegisterPlugin", payload=REGISTER_INNER,
                       timeout_nano=10_000_000_000
                       ).SerializeToString() == REGISTER_REQUEST
    assert tpb.Response().SerializeToString() == EMPTY_RESPONSE


def test_port_client_emits_golden_register_bytes():
    t = nri("torch", "ttrpc")
    a, b = socket.socketpair()
    try:
        client = t.TtrpcClient(t.Mux(a).conn(t.RUNTIME_SERVICE_CONN))
        got = {}

        def respond():
            want = mux_frame(2, ttrpc_frame(1, 1, REGISTER_REQUEST))
            got["bytes"], got["want"] = b.recv(len(want) + 64), want
            b.sendall(mux_frame(2, ttrpc_frame(1, 2, EMPTY_RESPONSE)))

        thr = threading.Thread(target=respond)
        thr.start()
        payload = client.call("nri.pkg.api.v1alpha1.Runtime",
                              "RegisterPlugin", REGISTER_INNER,
                              timeout=10.0)
        thr.join(timeout=10)
        assert got["bytes"] == got["want"], got
        assert payload == b""
    finally:
        a.close()
        b.close()


def _read_frame(sock, buf=b""):
    """(conn id, ttrpc frame, rest of the buffer) of one mux frame."""
    while len(buf) < 8:
        buf += sock.recv(4096)
    cid, ln = struct.unpack(">II", buf[:8])
    while len(buf) < 8 + ln:
        buf += sock.recv(4096)
    return cid, buf[8:8 + ln], buf[8 + ln:]


def test_port_client_stream_ids_are_odd_and_advance_by_two():
    t = nri("torch", "ttrpc")
    a, b = socket.socketpair()
    try:
        client = t.TtrpcClient(t.Mux(a).conn(t.RUNTIME_SERVICE_CONN))
        seen = []

        def respond(n):
            buf = b""
            for _ in range(n):
                cid, frame, buf = _read_frame(b, buf)
                _, sid, mtype, _ = struct.unpack(">IIBB", frame[:10])
                seen.append((cid, sid, mtype))
                b.sendall(mux_frame(2, ttrpc_frame(sid, 2, b"")))

        thr = threading.Thread(target=respond, args=(3,))
        thr.start()
        for _ in range(3):
            client.call("svc", "M", b"", timeout=10.0)
        thr.join(timeout=10)
        assert seen == [(2, 1, 1), (2, 3, 1), (2, 5, 1)]
    finally:
        a.close()
        b.close()


def test_port_server_answers_golden_frames_in_kind():
    t = nri("torch", "ttrpc")
    api = nri("torch", "nri_api_pb2")
    tpb = nri("torch", "ttrpc_messages_pb2")
    a, b = socket.socketpair()
    try:
        calls = []

        def configure(payload):
            calls.append(payload)
            return api.ConfigureResponse(events=0).SerializeToString()

        server = t.TtrpcServer(t.Mux(a).conn(t.PLUGIN_SERVICE_CONN),
                               {"nri.pkg.api.v1alpha1.Plugin":
                                {"Configure": configure}})
        inner = field_bytes(2, b"containerd") + field_bytes(3, b"2.0.0")
        b.sendall(mux_frame(1, ttrpc_frame(7, 1, (
            field_bytes(1, b"nri.pkg.api.v1alpha1.Plugin")
            + field_bytes(2, b"Configure") + field_bytes(3, inner)))))
        cid, frame, _ = _read_frame(b)
        length, sid, mtype, flags = struct.unpack(">IIBB", frame[:10])
        assert (cid, sid, mtype, flags) == (1, 7, 2, 0)
        resp = tpb.Response.FromString(frame[10:10 + length])
        assert resp.status.code == 0 and resp.payload == b""
        assert calls == [inner]
        server.stop()
    finally:
        a.close()
        b.close()


def test_port_headers_are_the_jax_packages():
    t, jt = nri("torch", "ttrpc"), nri("jax", "ttrpc")
    assert t._MUX_HEADER.format == jt._MUX_HEADER.format == ">II"
    assert t._TTRPC_HEADER.format == jt._TTRPC_HEADER.format == ">IIBB"
    assert (t.PLUGIN_SERVICE_CONN, t.RUNTIME_SERVICE_CONN) == (1, 2)
    # Both packages' descriptors are one file in the default pool.
    assert nri("torch", "nri_api_pb2").DESCRIPTOR.serialized_pb == \
        nri("jax", "nri_api_pb2").DESCRIPTOR.serialized_pb


# ---------- a runtime of one package, a plugin of the other ----------

def fake_runtime(sock, pkg: str):
    """The runtime side of one NRI connection, on `pkg`'s transport:
    the Runtime service on conn 2 (RegisterPlugin, UpdateContainers,
    whose un-appliable updates come back as failed), a client of the
    Plugin service on conn 1."""
    t, api = nri(pkg, "ttrpc"), nri(pkg, "nri_api_pb2")
    seen = {"registered": [], "updates": []}

    def register_plugin(payload):
        seen["registered"].append(api.RegisterPluginRequest.FromString(
            payload))
        return api.Empty().SerializeToString()

    def update_containers(payload):
        req = api.UpdateContainersRequest.FromString(payload)
        seen["updates"].extend(req.update)
        resp = api.UpdateContainersResponse()
        for u in req.update:
            if u.container_id == "gone":
                resp.failed.add().CopyFrom(u)
        return resp.SerializeToString()

    mux = t.Mux(sock)
    server = t.TtrpcServer(mux.conn(t.RUNTIME_SERVICE_CONN), {
        "nri.pkg.api.v1alpha1.Runtime": {
            "RegisterPlugin": register_plugin,
            "UpdateContainers": update_containers}})
    client = t.TtrpcClient(mux.conn(t.PLUGIN_SERVICE_CONN))
    return mux, server, client, seen


def connect(runtime_pkg: str, plugin_pkg: str, name="tpu-device-injector"):
    """A runtime of one package and the other's plugin, registered over
    a socketpair: (runtime (mux, server, client, seen), plugin (mux,
    server, runtime client))."""
    runtime_sock, plugin_sock = socket.socketpair()
    runtime = fake_runtime(runtime_sock, runtime_pkg)
    plugin = {}

    def plugin_side():
        plugin["conn"] = nri(plugin_pkg, "daemon").serve_connection(
            plugin_sock, name, "10")

    thr = threading.Thread(target=plugin_side, daemon=True)
    thr.start()
    thr.join(timeout=10)
    assert not thr.is_alive(), "plugin registration hung"
    return runtime, plugin["conn"]


def close(runtime, plugin):
    plugin[1].stop()
    runtime[1].stop()
    runtime[0].close()
    plugin[0].close()


def runtime_script(runtime, runtime_pkg: str, node: str) -> list:
    """Configure, Synchronize, CreateContainer for an annotated container
    (the node, then a missing path, then a malformed annotation), one
    without annotations and an unknown method: each answer as bytes or
    as the RPC error's text."""
    api = nri(runtime_pkg, "nri_api_pb2")
    client = runtime[2]
    plugin = "nri.pkg.api.v1alpha1.Plugin"

    def call(method, msg):
        try:
            return client.call(plugin, method, msg.SerializeToString())
        except RuntimeError as e:
            return str(e)

    def create(annotation):
        pod = api.PodSandbox(name="train", namespace="ml")
        if annotation is not None:
            pod.annotations[nri(runtime_pkg).ANNOTATION_PREFIX
                            + "sidecar"] = annotation
        return call("CreateContainer", api.CreateContainerRequest(
            pod=pod, container=api.Container(name="sidecar")))

    return [call("Configure", api.ConfigureRequest(
                runtime_name="containerd", runtime_version="2.0")),
            call("Synchronize", api.SynchronizeRequest()),
            create(f"- path: {node}\n"),
            create("- path: /dev/nvidia-absent\n"),
            create("not a list"),
            create(None),
            call("NoSuchMethod", api.Empty())]


@pytest.mark.parametrize("runtime_pkg,plugin_pkg", [
    ("jax", "torch"), ("torch", "jax")])
def test_cross_package_wire_exchange_gives_the_same_answers(runtime_pkg,
                                                            plugin_pkg):
    answers = {}
    for rt, pl in ((runtime_pkg, plugin_pkg), (runtime_pkg, runtime_pkg)):
        runtime, plugin = connect(rt, pl)
        try:
            assert [r.plugin_name for r in runtime[3]["registered"]] == [
                "tpu-device-injector"]
            answers[pl] = runtime_script(runtime, rt, "/dev/null")
        finally:
            close(runtime, plugin)
    assert answers[plugin_pkg] == answers[runtime_pkg]
    api = nri(runtime_pkg, "nri_api_pb2")
    configure, _, created, missing, malformed, plain, unknown = answers[
        plugin_pkg]
    assert api.ConfigureResponse.FromString(configure).events == 1 << 3
    devs = api.CreateContainerResponse.FromString(created).adjust.linux.devices
    assert [(d.path, d.type, d.major, d.minor) for d in devs] == [
        ("/dev/null", "c", 1, 3)]
    assert "rpc error 13" in missing and "cannot inject" in missing
    assert "rpc error 13" in malformed and "YAML list" in malformed
    assert api.CreateContainerResponse.FromString(
        plain).adjust.linux.devices == []
    assert "rpc error 12" in unknown


# ---------- the port's plugin end to end ----------

def test_port_plugin_end_to_end(tmp_path):
    api = nri("torch", "nri_api_pb2")
    daemon = nri("torch", "daemon")
    runtime, plugin = connect("torch", "torch")
    try:
        client = runtime[2]
        resp = api.ConfigureResponse.FromString(client.call(
            daemon.PLUGIN_SERVICE, "Configure",
            api.ConfigureRequest(runtime_name="containerd",
                                 runtime_version="2.0").SerializeToString()))
        assert resp.events & daemon.CREATE_CONTAINER_MASK
        sync = api.SynchronizeResponse.FromString(client.call(
            daemon.PLUGIN_SERVICE, "Synchronize",
            api.SynchronizeRequest().SerializeToString()))
        assert list(sync.update) == []
        if os.getuid() == 0:
            paths = list(_mknod_nvidia(tmp_path).values())
        else:
            paths = ["/dev/null"]
        pod = api.PodSandbox(name="train", namespace="ml")
        pod.annotations[nri("torch").ANNOTATION_PREFIX + "sidecar"] = "".join(
            f"- path: {p}\n" for p in paths)
        cresp = api.CreateContainerResponse.FromString(client.call(
            daemon.PLUGIN_SERVICE, "CreateContainer",
            api.CreateContainerRequest(
                pod=pod, container=api.Container(name="sidecar"))
            .SerializeToString()))
        got = [(d.path, d.type, d.major, d.minor, d.uid.value, d.gid.value)
               for d in cresp.adjust.linux.devices]
        want = []
        for p in paths:
            st = os.stat(p)
            want.append((p, "c", os.major(st.st_rdev), os.minor(st.st_rdev),
                         st.st_uid, st.st_gid))
        assert got == want
        # A plugin-initiated UpdateContainers: the runtime echoes back
        # the update it could not apply.
        good = api.ContainerUpdate(container_id="c1")
        good.linux.resources.cpu.shares.value = 2048
        good.linux.resources.cpu.quota.value = -1
        good.linux.resources.memory.limit.value = 1 << 30
        gone = api.ContainerUpdate(container_id="gone", ignore_failure=False)
        failed = daemon.update_containers(plugin[2], [good, gone])
        assert [u.container_id for u in runtime[3]["updates"]] == [
            "c1", "gone"]
        assert [u.container_id for u in failed] == ["gone"]
        assert runtime[3]["updates"][0].linux.resources.cpu.quota.value == -1
    finally:
        close(runtime, plugin)


def test_port_malformed_annotation_is_rpc_error():
    api = nri("torch", "nri_api_pb2")
    runtime, plugin = connect("torch", "torch", name="x")
    try:
        pod = api.PodSandbox(name="p")
        pod.annotations[nri("torch").ANNOTATION_PREFIX + "c"] = "not a list"
        with pytest.raises(RuntimeError, match="rpc error 13"):
            runtime[2].call("nri.pkg.api.v1alpha1.Plugin", "CreateContainer",
                            api.CreateContainerRequest(
                                pod=pod, container=api.Container(name="c"))
                            .SerializeToString())
    finally:
        close(runtime, plugin)


def test_port_daemon_keeps_the_jax_flags_and_plugin_name(monkeypatch,
                                                        tmp_path):
    """main() of both packages with their default flags on a listening
    socket: the same plugin name and index reach serve_connection."""
    sock_path = str(tmp_path / "nri.sock")
    listener = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    listener.bind(sock_path)
    listener.listen(4)
    seen = {}
    try:
        for pkg in sorted(PACKAGES):
            daemon = nri(pkg, "daemon")

            def serve(sock, name, idx, pkg=pkg):
                seen[pkg] = (name, idx)
                raise RuntimeError("stop here")

            def stop(seconds):
                raise SystemExit(0)

            monkeypatch.setattr(daemon, "serve_connection", serve)
            monkeypatch.setattr(daemon.time, "sleep", stop)
            with pytest.raises(SystemExit):
                daemon.main(["--nri-socket", sock_path])
    finally:
        listener.close()
    assert seen == {"jax": ("tpu-device-injector", "10"),
                    "torch": ("tpu-device-injector", "10")}
    assert nri("torch", "daemon").NRI_SOCKET == nri("jax", "daemon").NRI_SOCKET
