"""The port's load generator in watcher mode, held to the reference's
test: ``tests/test_watch.py::test_loadgen_watcher_mode_oracle_clean``
runs again with its in-body ``bench.loadgen`` import pointed at the
port (every engine on the CPU): long-poll watchers chase the publish
pointer while the write load runs, every push read feeds the session
oracle at zero violations, and the registries drain.

The load generator's other replays live beside the reference tests
they come from: ``test_torch_oracle.py`` (one server, the giant racer,
shedding), ``test_torch_mergetier.py`` (the tier armed),
``test_torch_cluster.py`` and ``test_torch_netchaos.py`` (the fleet
mode, clean and under chaos).
"""
import test_watch as ref  # noqa: E402 — configures JAX for the CPU
import _torch_replay  # noqa: E402


def test_loadgen_watcher_mode_passes_on_port(tmp_path, monkeypatch):
    _torch_replay.run(ref, "test_loadgen_watcher_mode_oracle_clean", None,
                      tmp_path, monkeypatch, modules=(
                          (_torch_replay.LOADGEN,
                           _torch_replay.port_loadgen()),))
