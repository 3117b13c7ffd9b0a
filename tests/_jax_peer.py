"""The JAX package's process worker (``python -m repro.runtime.peer``) with
each peer's inbox made when the first frame from that peer arrives, for the
port's parity tests that run the JAX ``ProcessRunner``.

    python tests/_jax_peer.py --spec SPEC --worker W [--epoch E] [--rejoin]

The JAX worker makes peer v's inbox only when its own dial loop reaches v,
after the rendezvous (``src/repro/runtime/peer.py``, ``main``).  A peer
that is further along may already have dialled it and sent its round-0
rows.  The handler of that connection then dies on a ``KeyError``, the
rows and every heartbeat on that connection are lost, and the barrier takes
v for dead after ``dead_timeout_s``.  Under a loaded host this happened in
the port's parity test: ``faults_detected`` 2, one worker declaring v dead
in round 0 and v declaring it dead in round 1.  The port's worker makes
every inbox at construction (``repro_torch/runtime/peer.py``).  Here the
dial loop's assignment keeps a queue that an early frame already made;
nothing else of the JAX worker changes.

``jax_runner_launches_this(monkeypatch)`` points the JAX runner's worker
launches at this file.
"""
import asyncio
import subprocess
import sys
from pathlib import Path


class EarlyInboxes(dict):
    """Inboxes made on a peer's first frame; a later assignment by the dial
    loop keeps the queue that holds it."""

    def __missing__(self, v):
        q = asyncio.Queue()
        dict.__setitem__(self, v, q)
        return q

    def __setitem__(self, v, q):
        if v not in self:
            dict.__setitem__(self, v, q)


def jax_runner_launches_this(monkeypatch):
    """Make ``repro.runtime.runner``'s ``subprocess.Popen`` of
    ``-m repro.runtime.peer`` run this file with the same arguments."""
    from repro.runtime import runner

    class _Subprocess:
        def __getattr__(self, name):
            return getattr(subprocess, name)

        @staticmethod
        def Popen(cmd, **kw):
            i = cmd.index("repro.runtime.peer")
            assert cmd[i - 1] == "-m"
            return subprocess.Popen([*cmd[:i - 1], str(Path(__file__).resolve()), *cmd[i + 1:]],
                                    **kw)

    monkeypatch.setattr(runner, "subprocess", _Subprocess())


if __name__ == "__main__":
    from repro.runtime import peer

    init = peer.PeerWorker.__init__

    def __init__(self, *args, **kw):
        init(self, *args, **kw)
        self.inbox = EarlyInboxes()

    peer.PeerWorker.__init__ = __init__
    sys.exit(peer.main())
