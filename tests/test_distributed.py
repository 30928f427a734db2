"""True multi-process ``jax.distributed`` tests.

Two localhost CPU processes (Gloo collectives) run the real pod driver —
``initialize_multihost`` bring-up, ``host_local_batch`` split,
``make_array_from_process_local_data`` assembly, and a sharded encode+decode
— and the result checksum must equal a single-process run of the identical
global config.  This covers the bring-up path the virtual-device mesh tests
cannot (they are one process).
"""
import os
import re
import socket
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
POD = os.path.join(REPO, "scripts", "encode_pod.py")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _clean_env(n_devices: int) -> dict:
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={n_devices}"
    env["PYTHONPATH"] = REPO
    return env


def _run(args, env, timeout=600):
    return subprocess.run(
        [sys.executable, POD] + args,
        env=env, capture_output=True, text=True, timeout=timeout,
    )


def _checksums(out: str) -> dict:
    found = {}
    m = re.search(r"^checksum: (-?\d+)", out, re.M)
    if m:
        found["encode"] = int(m.group(1))
    m = re.search(r"^decode checksum: (-?\d+)", out, re.M)
    if m:
        found["decode"] = int(m.group(1))
    return found


@pytest.mark.parametrize("strategy", ["ranges", "domains"])
def test_two_process_pod_matches_single_process(strategy):
    """Spawn the pod driver twice against a localhost coordinator; the
    2-process global result must equal the 1-process result bitwise
    (checksum of winners + decode output)."""
    port = _free_port()
    common = ["--batch", "4", "--size", "64", "--reps", "1", "--n-data", "2",
              "--strategy", strategy, "--decode"]
    procs = [
        subprocess.Popen(
            [sys.executable, POD] + common + [
                "--coordinator", f"127.0.0.1:{port}",
                "--num-processes", "2", "--process-id", str(i),
            ],
            env=_clean_env(2), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True,
        )
        for i in range(2)
    ]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out)
    assert all(p.returncode == 0 for p in procs), outs
    assert "multihost up" in outs[0] and "'process_count': 2" in outs[0].replace(
        "process_count=2", "'process_count': 2"), outs[0]
    chk2 = _checksums(outs[0] + outs[1])
    assert "encode" in chk2 and "decode" in chk2, outs

    # identical global config in ONE process with 4 local devices
    single = _run(common, _clean_env(4))
    assert single.returncode == 0, single.stdout + single.stderr
    chk1 = _checksums(single.stdout)
    assert chk1["encode"] == chk2["encode"], (chk1, chk2)
    assert chk1["decode"] == chk2["decode"], (chk1, chk2)


def test_initialize_multihost_failure_is_contextual():
    """A bad coordinator must fail with the contextual RuntimeError from
    initialize_multihost (parallel/distributed.py:44-51), not a raw
    backend traceback."""
    r = _run(
        ["--batch", "2", "--size", "64", "--reps", "1",
         "--coordinator", "127.0.0.1:1", "--num-processes", "2",
         "--process-id", "1", "--init-timeout", "5"],
        env=_clean_env(2), timeout=300,
    )
    assert r.returncode != 0
    blob = r.stdout + r.stderr
    assert "multi-host initialization failed" in blob, blob[-2000:]


@pytest.mark.parametrize("coord,n,pid,explicit,platforms,want", [
    ("localhost:1234", 4, 2, None, "", [2]),        # GPU host: own card
    ("127.0.0.1:1", 2, 0, None, "cuda", [0]),
    ("localhost:1234", 4, 2, [3], "", [3]),         # explicit single id
    ("localhost:1234", 2, 1, None, "cpu", None),    # CPU run: no restriction
    ("10.0.0.5:1234", 2, 1, None, "", None),        # other host: JAX decides
    ("localhost:1234", 1, 0, None, "", None),       # single process
    (None, None, None, [1], "", [1]),
])
def test_one_card_per_process(coord, n, pid, explicit, platforms, want):
    from fractencode_tpu.parallel.distributed import one_card_per_process

    assert one_card_per_process(coord, n, pid, explicit, platforms) == want


def test_several_cards_for_one_of_several_local_processes_refused():
    from fractencode_tpu.parallel.distributed import one_card_per_process

    with pytest.raises(ValueError, match="one card"):
        one_card_per_process("localhost:9", 2, 0, [0, 1], "cuda")
