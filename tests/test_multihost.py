"""Real 2-process multi-host training step (VERDICT r1 item 5).

Launches scripts/multihost_smoke.py twice with jax.distributed.initialize
over a localhost coordinator (4 virtual CPU devices per process -> one
8-device global Mesh('env')), runs two shard_map minimize steps, and checks
the pmean'd parameter update is bit-identical on both hosts.
"""

import os
import socket
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_training_step():
    coord = f"localhost:{_free_port()}"
    env = dict(os.environ)
    env.update({
        "JAX_PLATFORMS": "cpu",
        "XLA_FLAGS": "--xla_force_host_platform_device_count=4",
        "PYTHONPATH": os.pathsep.join(
            p for p in (REPO, os.environ.get("PYTHONPATH")) if p),
    })
    procs = [
        subprocess.Popen(
            [sys.executable, os.path.join(REPO, "scripts", "multihost_smoke.py"),
             "--num_processes", "2", "--process_id", str(i),
             "--coordinator", coord],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        for i in range(2)
    ]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=540)
        assert p.returncode == 0, f"rc={p.returncode}\n{out}\n{err[-2000:]}"
        outs.append(out)

    lines = [l for o in outs for l in o.splitlines() if l.startswith("MULTIHOST_OK")]
    assert len(lines) == 2, outs
    digests = {l.split("params=")[1] for l in lines}
    rewards = {l.split("reward=")[1].split()[0] for l in lines}
    assert len(digests) == 1, lines  # bit-identical params on both hosts
    assert len(rewards) == 1, lines
