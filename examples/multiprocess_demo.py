"""Multi-process (multi-host analog) execution of the sharded step.

Launches N worker processes on this machine, each owning a slice of virtual
CPU devices; `jax.distributed.initialize` (through
parallel.mesh.maybe_initialize_distributed — the same entry point the CLI
uses for real multi-host runs) brings up the coordinator, the global
mesh spans every process, and the production transport+chemistry step runs
under GSPMD with the halo exchanges crossing the process boundary — the
mechanics of the DCN path, exercised end to end (SURVEY.md §5.8; the
reference is serial, equiSources.f90 has no analog).

    python examples/multiprocess_demo.py                # parent: spawn 2
    python examples/multiprocess_demo.py --procs 2 --check

Each worker prints `pid=K neutral=X`; the parent verifies every process
agrees with a single-process run of the identical configuration to 1e-12.
"""

import argparse
import os
import subprocess
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

PORT = 29541


def _build(n, dtype_str):
    import jax.numpy as jnp

    from radiativetransfer_tpu.config import (MODE_UVB_TRANSFER_ONLY,
                                              RunConfig)
    from radiativetransfer_tpu.constants import KPC, MH, PSI
    from radiativetransfer_tpu.core import step as step_mod
    from radiativetransfer_tpu.core.state import GridGeometry, make_state

    rng = np.random.default_rng(42)
    nh = rng.lognormal(0, 0.5, (n, n, n)) * 1e-3
    dtype = jnp.float64 if dtype_str == "f64" else jnp.float32
    state = make_state(nh * MH / PSI, np.full((n, n, n), 1e4), nh,
                       dtype=dtype)
    cfg = RunConfig(mode=MODE_UVB_TRANSFER_ONLY, current_redshift=6.55,
                    n_angular_level=1, reionization_model=10, grid="mp")
    geom = GridGeometry(n, n, n, 300.0 * KPC)
    rt = step_mod.RTModel.setup(cfg, geom, dtype=dtype)
    return rt, state


def worker(pid: int, procs: int, n: int, local_devices: int):
    os.environ["XLA_FLAGS"] = (
        f"--xla_force_host_platform_device_count={local_devices}")
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)

    from radiativetransfer_tpu.parallel import mesh as pmesh

    active = pmesh.maybe_initialize_distributed(
        coordinator=f"localhost:{PORT}", num_processes=procs,
        process_id=pid)
    assert active, "distributed runtime did not come up"
    ndev = len(jax.devices())
    assert ndev == procs * local_devices

    rt, state = _build(n, "f64")
    mesh = pmesh.make_grid_mesh()
    state = pmesh.shard_state_global(state, mesh)
    step = jax.jit(rt.transport_chemistry_step)
    out = step(state)
    nf = rt.neutral_fraction(out)
    print(f"pid={pid} ndev={ndev} neutral={nf:.14e}", flush=True)


def single_reference(n: int) -> float:
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    rt, state = _build(n, "f64")
    out = jax.jit(rt.transport_chemistry_step)(state)
    return rt.neutral_fraction(out)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--procs", type=int, default=2)
    ap.add_argument("--local-devices", type=int, default=2)
    ap.add_argument("--n", type=int, default=16)
    ap.add_argument("--worker", type=int, default=None)
    ap.add_argument("--check", action="store_true",
                    help="parent also runs the single-process reference")
    args = ap.parse_args()

    if args.worker is not None:
        worker(args.worker, args.procs, args.n, args.local_devices)
        return

    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    env["PYTHONPATH"] = os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))) + os.pathsep + env.get("PYTHONPATH", "")
    cmd = [sys.executable, os.path.abspath(__file__),
           "--procs", str(args.procs), "--n", str(args.n),
           "--local-devices", str(args.local_devices)]
    procs = [subprocess.Popen(cmd + ["--worker", str(i)], env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT)
             for i in range(args.procs)]
    outs = []
    ok = True
    for i, p in enumerate(procs):
        try:
            out, _ = p.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            p.kill()
            out, _ = p.communicate()
        text = out.decode()
        outs.append(text)
        if p.returncode != 0:
            ok = False
            print(f"worker {i} FAILED rc={p.returncode}\n{text[-2000:]}")
    if not ok:
        sys.exit(1)

    values = []
    for text in outs:
        for line in text.splitlines():
            if line.startswith("pid="):
                print(line)
                values.append(float(line.split("neutral=")[1]))
    assert len(values) == args.procs, outs
    assert all(abs(v - values[0]) < 1e-13 for v in values), values

    if args.check:
        ref = single_reference(args.n)
        err = abs(values[0] - ref) / ref
        print(f"single-process reference neutral={ref:.14e} "
              f"rel-err={err:.2e}")
        assert err < 1e-12, (values[0], ref)
    print("multiprocess OK")


if __name__ == "__main__":
    main()
