"""``mmlspark-tpu-torch`` CLI: serve, the process fleet, its tools, run.

The port's copy of the serving half of ``mmlspark_tpu/cli.py``, with the
reference's flags and stdout contract:

- ``serve``: the micro-batching server behind the stdlib HTTP front end,
  one ``TorchModel`` per ``--model NAME=ARCH[:JSON-kwargs]``; with
  ``--replicas > 1`` an in-process ``Fleet`` (and ``--autopilot`` over
  it). Prints ONE JSON line announcing the bound address (first on
  stdout: a supervisor reads it over a pipe) and drains on SIGTERM /
  SIGINT through :mod:`~mmlspark_tpu_torch.reliability.preemption`.
- ``fleet``: N ``serve`` worker PROCESSES under a
  :class:`~mmlspark_tpu_torch.serve.supervisor.Supervisor` behind one
  router (``--hosts`` fans one fleet out per host through
  :class:`~mmlspark_tpu_torch.serve.launcher.HostLauncher`;
  ``--autopilot`` scales real workers through ``ProcessFleet``).
- ``loadgen``: a seeded open-loop schedule's preview and fingerprint.
- ``autopilot replay``: the pure decision core re-run over recorded
  ``autopilot_signals`` events, ranked against candidate policies.

- ``run``: a script in a ``torch.distributed`` process group, the
  reference's launcher: ``--mesh`` sets ``runtime.mesh`` (which
  ``mesh_from_config``, the trainer and ``DeepClassifier`` read),
  ``--coordinator`` / ``--num-processes`` / ``--process-id`` (or
  ``--hosts`` and ``--port``) join the group, ``--platform`` picks the
  device (``cuda``: card ``local_rank % device_count``; ``cpu``), and
  ``--nprocs N`` starts N local ranks of the same command and waits for
  them. Each rank states its rank, device and backend on stderr.

- ``launch-pod``: the same ``run`` command on every host of a GPU pod
  over ssh (``ssh HOST 'cd APP && python -m mmlspark_tpu_torch.cli run
  SCRIPT --hosts H1,H2,... --process-id I'``), ``--dry-run`` printing
  the per-host argv list as JSON.
- ``report``: the run report of one or more event logs (or flight-
  recorder dumps), ``--json`` for its structured form, ``--trace`` to
  also export a Chrome trace of the same log.
- ``info``: the devices this process sees (``device_count_summary``), the
  platform (``gpu`` with a card, else ``cpu``), the card's name, the torch
  and CUDA versions and ``config.snapshot()``, as JSON.
- ``check``: the static reliability lint (``reliability/lint.py``) over
  the installed package or the given roots; exit 1 on any problem.
- ``top``: the live fleet dashboard over ``--replica`` HTTP addresses
  (``--once`` prints one frame).
- ``chaos``: a seeded chaos scenario (``reliability/chaos.py``); the
  verdict JSON on stdout and in ``chaos_verdict.json``, exit 0 iff every
  invariant held; an unknown ``--scenario`` lists the registered ones and
  exits 2.
- ``bench``: ``./bench.py`` of the working directory with ``--baseline``
  passed on, its bench line gated through ``observability/benchgate.py``:
  the verdict is the last stdout line, exit 1 when it is red.

Workers run on ``runtime.device`` (``MMLSPARK_TPU_TORCH_RUNTIME_DEVICE``)
and raise without CUDA unless it is ``cpu``. An unhandled exception in
any command dumps the flight recorder's ring (reason ``crash``) before it
propagates. The reference's ``info``, ``check``, ``bench``, ``chaos`` and
``top`` are not ported yet (ROADMAP queue A).
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
from typing import List, Optional


def cmd_loadgen(args, passthrough) -> int:
    """Preview a seeded open-loop workload schedule (testing/loadgen):
    prints the trace spec, arrival count, offered QPS, per-bucket
    arrival counts, and the sha256 schedule fingerprint — the replay
    contract (same seed + trace -> same fingerprint, byte for byte)."""
    from mmlspark_tpu_torch.testing import loadgen
    trace = loadgen.Trace(
        duration_s=args.duration, rate=args.rate, shape=args.shape,
        process=args.process, spike_start_s=args.spike_start,
        spike_len_s=args.spike_len, spike_factor=args.spike_factor,
        pareto_alpha=args.pareto_alpha,
        session_turns=args.session_turns, think_s=args.think)
    schedule = loadgen.generate(trace, args.seed)
    fingerprint = loadgen.schedule_fingerprint(schedule)
    buckets = loadgen.bucket_counts(schedule, args.bucket) \
        if args.bucket > 0 else []
    offered_qps = (len(schedule) / trace.duration_s
                   if trace.duration_s > 0 else 0.0)
    if getattr(args, "json", False):
        print(json.dumps({  # lint: allow-print
            "trace": trace.describe(), "seed": args.seed,
            "arrivals": len(schedule), "fingerprint": fingerprint,
            "offered_qps": round(offered_qps, 4),
            "bucket_s": args.bucket, "buckets": buckets},
            sort_keys=True))
        return 0
    print(f"trace: {trace.describe()}")  # lint: allow-print
    print(f"seed {args.seed}: {len(schedule)} arrivals "  # lint: allow-print
          f"({offered_qps:.2f} offered qps)")
    if buckets:
        print(f"per-{args.bucket:g}s buckets: {buckets}")  # lint: allow-print
    print(f"fingerprint: {fingerprint}")  # lint: allow-print
    return 0


def _parse_model_flag(text: str):
    """``NAME=ARCH[:JSON-kwargs]`` -> (name, architecture, kwargs)."""
    name, sep, rest = text.partition("=")
    if not sep or not name or not rest:
        raise SystemExit(
            f"--model: expected NAME=ARCH[:JSON-kwargs], got {text!r}")
    arch, sep2, blob = rest.partition(":")
    kwargs = {}
    if sep2:
        try:
            kwargs = json.loads(blob)
        except json.JSONDecodeError as e:
            raise SystemExit(f"--model {name}: bad JSON kwargs ({e})")
        if not isinstance(kwargs, dict):
            raise SystemExit(
                f"--model {name}: kwargs must be a JSON object, got "
                f"{type(kwargs).__name__}")
    return name, arch, kwargs


def cmd_serve(args, passthrough) -> int:
    """Start the micro-batching inference server behind the stdlib HTTP
    front end. Blocks until interrupted; SIGTERM/SIGINT drain gracefully —
    admission stops (503 + Retry-After), in-flight batches finish, open
    generate sequences are answered or failed retryably, then the server
    closes."""
    import threading
    from mmlspark_tpu_torch import compile_cache
    from mmlspark_tpu_torch.models.torch_model import TorchModel
    from mmlspark_tpu_torch.observability import memory as devmem
    from mmlspark_tpu_torch.reliability import preemption
    from mmlspark_tpu_torch.reliability.watchdog import Watchdog
    from mmlspark_tpu_torch.serve.http import serve_http
    from mmlspark_tpu_torch.serve.server import Server
    from mmlspark_tpu_torch.utils import config as mmlconfig
    if getattr(args, "events_dir", ""):
        # per-pid sidecar convention: this worker appends to its OWN
        # events-<pid>.jsonl under the shared directory
        os.makedirs(args.events_dir, exist_ok=True)
        mmlconfig.set("observability.events_path",
                      os.path.join(args.events_dir,
                                   f"events-{os.getpid()}.jsonl"))
    compile_cache.enable_from_config()
    if not args.model:
        raise SystemExit(
            "serve: at least one --model NAME=ARCH[:JSON-kwargs] required "
            '(e.g. --model "mlp=mlp_tabular:{\\"input_dim\\": 8}")')
    models = {}
    for spec in args.model:
        name, arch, kwargs = _parse_model_flag(spec)
        m = TorchModel(inputCol="x", outputCol="y")
        try:
            m.set_model(arch, **kwargs)
        except (KeyError, TypeError, ValueError) as e:
            raise SystemExit(f"--model {name}: {e}")
        models[name] = m
    buckets = [int(b) for b in args.buckets.split(",") if b.strip()] \
        if args.buckets else None
    server_kwargs = dict(max_batch=args.max_batch,
                         max_wait_ms=args.max_wait_ms,
                         queue_depth=args.queue_depth, buckets=buckets)
    devmem.start_audit_poller()  # no-op unless observability.memory_poll_s
    fleet = None
    scraper = None
    autopilot = None
    if args.replicas > 1:
        # fleet mode: N in-process replicas behind the health-checked
        # router (failover, fairness, rolling rollout)
        from mmlspark_tpu_torch.observability.aggregate import FleetScraper
        from mmlspark_tpu_torch.serve.fleet import Fleet
        fleet = Fleet(models, replicas=args.replicas,
                      server_kwargs=server_kwargs)
        fleet.router.start_prober()
        scraper = FleetScraper(fleet)
        scraper.start()
        if args.autopilot or bool(mmlconfig.get("autopilot.enabled")):
            from mmlspark_tpu_torch.control.autopilot import Autopilot
            autopilot = Autopilot(fleet)
            autopilot.start()
        front = fleet.router
    elif args.autopilot:
        raise SystemExit("serve: --autopilot needs --replicas > 1 "
                         "(the levers act on a fleet)")
    else:
        server = Server(models, **server_kwargs)
        front = server
    httpd, addr = serve_http(front, host=args.host, port=args.port)
    # stdout contract: one JSON line announcing the bound address, so
    # wrappers can discover an ephemeral --port 0; liveness and readiness
    # are reported SEPARATELY (the /livez vs /readyz split)
    h = front.health()
    print(json.dumps({"serving": addr,  # lint: allow-print
                      "models": front.registry.names(),
                      "replicas": args.replicas, "pid": os.getpid(),
                      "live": h["live"], "ready": h["ready"]}),
          flush=True)  # a supervisor reads this over a block-buffered pipe
    # graceful preemption: SIGTERM/SIGINT flip the process-wide signal;
    # this monitor turns it into drain (stop admission, finish in-flight)
    # then unblocks serve_forever. Handlers only install on the main
    # thread — in-process callers off-main keep plain Ctrl-C semantics.
    preemption.install_handlers()
    watchdog = Watchdog() \
        if float(mmlconfig.get("reliability.stall_timeout_s")) > 0 else None

    def monitor():
        preemption.get_signal().wait()
        reason = preemption.preemption_reason() or "signal"
        if fleet is not None:
            fleet.drain(reason=reason)
        else:
            server.drain(reason=reason)
        httpd.shutdown()

    mon = threading.Thread(target=monitor, daemon=True,
                           name="mmlspark-tpu-torch-serve-drain")
    mon.start()
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass  # clean Ctrl-C shutdown path (no handler installed off-main)
    finally:
        httpd.server_close()
        if autopilot is not None:
            autopilot.stop()
        if scraper is not None:
            scraper.stop()
        if fleet is not None:
            fleet.close()
        else:
            server.close()
        if watchdog is not None:
            watchdog.close()
        devmem.stop_audit_poller()
    return 0


def cmd_fleet(args, passthrough) -> int:
    """Launch a process fleet: every replica is its own ``serve`` OS
    process — own ephemeral port, own ``events-<pid>.jsonl`` sidecar —
    supervised with restart-on-crash (exponential backoff + per-replica
    circuit breaker) behind the health-checked HTTP router. SIGTERM drains
    every child before the front closes. Args after ``--`` are forwarded
    to each worker's ``serve`` command line verbatim.

    ``--hosts h1,h2`` (or ``--hosts-file``) switches to the multi-host
    launcher: one fleet (supervisor + workers) per host, each announced
    front stitched behind ONE router/scraper control plane here.
    ``--autopilot`` (single-host mode) runs the SLO-driven control loop
    with the scale lever actuating real worker processes
    (``Supervisor.add_slot``/``retire_slot`` via ``ProcessFleet``)."""
    import threading
    from mmlspark_tpu_torch.observability.aggregate import FleetScraper
    from mmlspark_tpu_torch.reliability import preemption
    from mmlspark_tpu_torch.serve.http import serve_http
    from mmlspark_tpu_torch.serve.router import Router
    from mmlspark_tpu_torch.serve.supervisor import ProcessSpawner, Supervisor
    from mmlspark_tpu_torch.utils import config as mmlconfig
    if not args.model:
        raise SystemExit(
            "fleet: at least one --model NAME=ARCH[:JSON-kwargs] required "
            '(e.g. --model "mlp=mlp_tabular:{\\"input_dim\\": 8}")')
    for spec in args.model:
        _parse_model_flag(spec)  # fail fast BEFORE spawning any worker
    replicas = args.replicas if args.replicas is not None \
        else int(mmlconfig.get("fleet.replicas"))
    if replicas < 1:
        raise SystemExit(f"fleet: --replicas must be >= 1, got {replicas}")
    hosts_spec = args.hosts or str(mmlconfig.get("fleet.hosts"))
    if args.hosts_file:
        from mmlspark_tpu_torch.serve.launcher import read_hosts_file
        if hosts_spec:
            raise SystemExit("fleet: --hosts and --hosts-file are "
                             "mutually exclusive")
        hosts = read_hosts_file(args.hosts_file)
    else:
        from mmlspark_tpu_torch.serve.launcher import parse_hosts
        hosts = parse_hosts(hosts_spec)
    if hosts:
        if args.autopilot:
            raise SystemExit(
                "fleet: --autopilot is single-host for now (each host's "
                "fleet supervises its own workers; run the autopilot "
                "per host)")
        return _fleet_multi_host(args, passthrough, hosts, replicas)
    events_dir = args.events_dir or os.path.join(os.getcwd(), "fleet-events")
    os.makedirs(events_dir, exist_ok=True)
    # the supervisor writes its OWN per-pid sidecar next to the workers'
    mmlconfig.set("observability.events_path",
                  os.path.join(events_dir, f"events-{os.getpid()}.jsonl"))
    cache_dir = args.compile_cache_dir \
        or str(mmlconfig.get("runtime.compile_cache_dir"))
    dpw = args.devices_per_worker if args.devices_per_worker is not None \
        else int(mmlconfig.get("fleet.devices_per_worker"))
    if dpw < 0:
        raise SystemExit(
            f"fleet: --devices-per-worker must be >= 0, got {dpw}")
    spawner = ProcessSpawner(
        args.model, host=args.host, events_dir=events_dir,
        compile_cache_dir=cache_dir or None,
        extra_args=list(passthrough), devices_per_worker=dpw)
    sup = Supervisor(spawner, [f"w{i}" for i in range(replicas)])
    scraper = None
    httpd = None
    autopilot = None
    try:
        sup.start()
        router = Router(sup.replicas)
        sup.attach_router(router)
        router.probe()
        router.start_prober()
        scraper = FleetScraper(router)
        scraper.start()
        sup.start_monitor()
        if args.autopilot or bool(mmlconfig.get("autopilot.enabled")):
            backend = str(mmlconfig.get("autopilot.scale_backend"))
            if backend == "inprocess":
                raise SystemExit(
                    "fleet: --autopilot over worker processes needs "
                    "autopilot.scale_backend=process (or auto), got "
                    f"{backend!r}")
            # the scale lever actuates REAL processes: scale_up spawns a
            # supervised worker, scale_down drains + retires one
            from mmlspark_tpu_torch.control.autopilot import Autopilot
            from mmlspark_tpu_torch.serve.fleet import ProcessFleet
            autopilot = Autopilot(ProcessFleet(sup, router),
                                  scraper=scraper)
            autopilot.start()
        httpd, addr = serve_http(router, host=args.host, port=args.port)
        h = router.health()
        print(json.dumps({"serving": addr,  # lint: allow-print
                          "replicas": replicas, "pid": os.getpid(),
                          "workers": sup.stats(),
                          "events_dir": events_dir,
                          "live": h["live"], "ready": h["ready"]},
                         default=str), flush=True)
        # SIGTERM/SIGINT -> drain every child through its own preemption
        # handler, stop restarting, then unblock serve_forever
        preemption.install_handlers()

        def monitor():
            preemption.get_signal().wait()
            reason = preemption.preemption_reason() or "signal"
            sup.shutdown(reason=reason)
            httpd.shutdown()

        mon = threading.Thread(target=monitor, daemon=True,
                               name="mmlspark-tpu-torch-fleet-drain")
        mon.start()
        try:
            httpd.serve_forever()
        except KeyboardInterrupt:
            pass  # clean Ctrl-C shutdown path
    finally:
        if httpd is not None:
            httpd.server_close()
        if autopilot is not None:
            autopilot.stop()
        if scraper is not None:
            scraper.stop()
        sup.shutdown()
    return 0


def _fleet_multi_host(args, passthrough, hosts, replicas) -> int:
    """The ``fleet --hosts`` control plane: one fleet process per host
    via :class:`~mmlspark_tpu_torch.serve.launcher.HostLauncher`, every
    announced host front behind one router + scraper here, SIGTERM
    fanning the drain out to every host."""
    import threading
    from mmlspark_tpu_torch.observability.aggregate import FleetScraper
    from mmlspark_tpu_torch.reliability import preemption
    from mmlspark_tpu_torch.serve.http import serve_http
    from mmlspark_tpu_torch.serve.launcher import HostLauncher
    from mmlspark_tpu_torch.serve.router import Router
    from mmlspark_tpu_torch.utils import config as mmlconfig
    events_dir = args.events_dir or os.path.join(os.getcwd(), "fleet-events")
    os.makedirs(events_dir, exist_ok=True)
    mmlconfig.set("observability.events_path",
                  os.path.join(events_dir, f"events-{os.getpid()}.jsonl"))
    extra = list(passthrough)
    if args.compile_cache_dir:
        extra = ["--compile-cache-dir", args.compile_cache_dir] + extra
    if args.devices_per_worker is not None:
        extra = ["--devices-per-worker",
                 str(args.devices_per_worker)] + extra
    launcher = HostLauncher(hosts, args.model,
                            replicas_per_host=replicas,
                            events_dir=events_dir, extra_args=extra)
    scraper = None
    httpd = None
    try:
        launcher.launch()
        router = Router(launcher.replicas())
        router.probe()
        router.start_prober()
        scraper = FleetScraper(router)
        scraper.start()
        httpd, addr = serve_http(router, host=args.host, port=args.port)
        h = router.health()
        print(json.dumps({"serving": addr,  # lint: allow-print
                          "hosts": launcher.stats(),
                          "replicas_per_host": replicas,
                          "pid": os.getpid(),
                          "events_dir": events_dir,
                          "live": h["live"], "ready": h["ready"]},
                         default=str), flush=True)
        preemption.install_handlers()

        def monitor():
            preemption.get_signal().wait()
            launcher.shutdown()
            httpd.shutdown()

        mon = threading.Thread(target=monitor, daemon=True,
                               name="mmlspark-tpu-torch-hosts-drain")
        mon.start()
        try:
            httpd.serve_forever()
        except KeyboardInterrupt:
            pass  # clean Ctrl-C shutdown path
    finally:
        if httpd is not None:
            httpd.server_close()
        if scraper is not None:
            scraper.stop()
        launcher.shutdown()
    return 0


def cmd_autopilot(args, passthrough) -> int:
    """Autopilot offline tooling. ``replay``: re-run the pure decision
    core over recorded ``autopilot_signals`` telemetry under the
    recorded policy (fidelity must be byte-identical) and any number of
    candidate threshold overrides, ranked by counterfactual shed / SLO
    burn / action count."""
    from mmlspark_tpu_torch.control import replay as rp
    if args.subcommand != "replay":  # pragma: no cover - argparse gates
        raise SystemExit(f"autopilot: unknown subcommand "
                         f"{args.subcommand!r}")
    log = rp.load_log(args.events)
    if not log["ticks"]:
        raise SystemExit(
            "autopilot replay: no autopilot_signals/tick events in the "
            "given log(s) — record a run with observability.events_path "
            "set and the autopilot on")
    recorded = rp.policy_from_fields(log["policy"] or {})
    fidelity = rp.fidelity_check(
        log["decisions"], rp.replay_decisions(log["ticks"], recorded))
    candidates = {"recorded": recorded}
    for spec in args.candidate:
        label, sep, rest = spec.partition(":")
        if not sep or not label:
            raise SystemExit(
                f"--candidate: expected LABEL:key=val[,key=val...], "
                f"got {spec!r}")
        try:
            candidates[label] = rp.policy_from_fields(
                log["policy"] or {}, rp.parse_overrides(rest))
        except ValueError as e:
            raise SystemExit(f"--candidate {label}: {e}")
    ranked = rp.rank_policies(log["ticks"], candidates)
    if args.json:
        print(json.dumps({"fidelity": fidelity, "ranking": ranked},  # lint: allow-print
                         sort_keys=True))
    else:
        print(rp.format_ranking(ranked, fidelity))  # lint: allow-print
    if log["policy"] is not None and not fidelity["identical"]:
        return 1  # the replay-sufficiency contract broke: make it loud
    return 0


def _resolve_hosts(args) -> None:
    """Fill the rendezvous from the environment and ``--hosts`` (the
    reference's rules: host 0 coordinates, this host's index is
    ``MMLSPARK_HOST_INDEX`` or its hostname's place in the list)."""
    def env_int(name):
        raw = os.environ.get(name)
        if raw is None:
            return None
        try:
            val = int(raw)
        except ValueError:
            raise SystemExit(f"{name}={raw!r} is not an integer")
        if val < 0:
            raise SystemExit(f"{name}={val} must be >= 0")
        return val

    if args.coordinator is None:
        args.coordinator = os.environ.get("MMLSPARK_COORDINATOR")
    if args.num_processes is None:
        args.num_processes = env_int("MMLSPARK_NUM_PROCESSES")
    if args.process_id is None:
        args.process_id = env_int("MMLSPARK_PROCESS_ID")
    if args.hosts:
        hosts = [h.strip() for h in args.hosts.split(",") if h.strip()]
        if not hosts:
            raise SystemExit("--hosts: empty host list")
        if args.coordinator is None:
            args.coordinator = f"{hosts[0]}:{args.port}"
        if args.num_processes is None:
            args.num_processes = len(hosts)
        if args.process_id is None:
            if os.environ.get("MMLSPARK_HOST_INDEX") is not None:
                args.process_id = env_int("MMLSPARK_HOST_INDEX")
            else:
                import socket
                me = {socket.gethostname(), socket.getfqdn(),
                      socket.gethostname().split(".")[0]}
                matches = [i for i, h in enumerate(hosts)
                           if h in me or h.split(".")[0] in me]
                if len(matches) != 1:
                    raise SystemExit(
                        f"--hosts: cannot identify this host among {hosts} "
                        f"(I am {sorted(me)}); set MMLSPARK_HOST_INDEX or "
                        "pass --process-id")
                args.process_id = matches[0]
    if args.process_id is not None and args.num_processes is not None \
            and args.process_id >= args.num_processes:
        raise SystemExit(f"process id {args.process_id} out of range for "
                         f"{args.num_processes} processes")


def _run_local_ranks(n: int, rank_argv, env=None) -> int:
    """``--nprocs N``: N ranks of a command on this host (rendezvous on a
    free localhost port, ``LOCAL_RANK`` / ``LOCAL_WORLD_SIZE`` set; rank
    ``r`` runs ``python -m mmlspark_tpu_torch.cli`` with
    ``rank_argv(r, coordinator)``), waited for; the first rank to fail
    stops the others. ``env`` is added to the ranks' environment. Returns
    the first non-zero exit code, else 0."""
    import subprocess
    import time
    from mmlspark_tpu_torch.testing.ranks import free_port
    coordinator = f"127.0.0.1:{free_port()}"
    procs = []
    try:
        for rank in range(n):
            argv = [sys.executable, "-m", "mmlspark_tpu_torch.cli"] \
                + rank_argv(rank, coordinator)
            rank_env = dict(os.environ, **(env or {}), LOCAL_RANK=str(rank),
                            LOCAL_WORLD_SIZE=str(n))
            procs.append(subprocess.Popen(argv, env=rank_env))  # lint: allow-process (the launcher owns its ranks until they exit)
        rc = 0
        while any(p.poll() is None for p in procs):
            failed = [p.returncode for p in procs
                      if p.returncode not in (None, 0)]
            if failed:
                rc = failed[0]
                break
            time.sleep(0.1)
        return rc or next((p.returncode for p in procs if p.returncode),
                          0)
    finally:
        for p in procs:
            if p.poll() is None:
                p.terminate()
        for p in procs:
            try:
                p.wait(10)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()


def cmd_run(args, passthrough) -> int:
    """Run ``args.script`` as ``__main__`` inside the process group, with
    ``runtime.mesh`` and the device set for it; both are restored when
    the script ends."""
    import runpy
    script = args.script
    if not os.path.exists(script):
        raise SystemExit(f"script not found: {script}")
    if args.mesh:
        from mmlspark_tpu_torch.parallel.mesh import parse_mesh_axes
        try:
            parse_mesh_axes(args.mesh)
        except ValueError as e:
            raise SystemExit(f"--mesh: {e}")
    if args.nprocs:
        if args.coordinator or args.hosts or args.process_id is not None:
            raise SystemExit("--nprocs starts every rank on this host; it "
                             "takes no --coordinator, --hosts or "
                             "--process-id")

        def rank_argv(rank, coordinator):
            argv = ["run", args.script, "--coordinator", coordinator,
                    "--num-processes", str(args.nprocs),
                    "--process-id", str(rank)]
            if args.mesh:
                argv += ["--mesh", args.mesh]
            if args.platform:
                argv += ["--platform", args.platform]
            return argv + ["--"] + passthrough
        return _run_local_ranks(args.nprocs, rank_argv)
    _resolve_hosts(args)
    with _in_group(args):
        saved_argv, saved_path = sys.argv, list(sys.path)
        sys.argv = [script] + passthrough
        sys.path.insert(0, os.path.dirname(os.path.abspath(script)))
        try:
            runpy.run_path(script, run_name="__main__")
        finally:
            sys.argv, sys.path[:] = saved_argv, saved_path
    return 0


@contextlib.contextmanager
def _in_group(args):
    """Join the process group of ``--coordinator`` / ``--num-processes`` /
    ``--process-id`` with ``runtime.mesh`` (``--mesh``) and the device
    (``--platform``; cuda takes card ``LOCAL_RANK % device_count``) set,
    state the rank on stderr, and yield its rank; leave the group and
    restore both keys at the end."""
    from mmlspark_tpu_torch.parallel import mesh as meshlib
    from mmlspark_tpu_torch.utils import config
    saved = {k: config._overrides.get(k) for k in ("runtime.mesh",
                                                   "runtime.device")}
    joined = False
    try:
        if getattr(args, "mesh", ""):
            config.set("runtime.mesh", args.mesh)
        if args.platform:
            config.set("runtime.device", args.platform)
        device = config.resolve_device()
        if device.type == "cuda" and device.index is None:
            import torch
            local = int(os.environ.get("LOCAL_RANK", args.process_id or 0))
            device = torch.device("cuda", local % torch.cuda.device_count())
            config.set("runtime.device", str(device))
            torch.cuda.set_device(device)
        was = meshlib.is_initialized()
        try:
            meshlib.initialize_multihost(args.coordinator,
                                         args.num_processes, args.process_id)
        except (ValueError, RuntimeError) as e:
            raise SystemExit(str(e))
        joined = meshlib.is_initialized() and not was
        summary = meshlib.device_count_summary()
        # one write of the whole line: ranks share the launcher's stderr,
        # and a statement and its newline written apart interleave
        sys.stderr.write(json.dumps(
            {"rank": summary["process_index"],
             "world": summary["process_count"], "device": str(device),
             "backend": str(config.get("runtime.dist_backend"))
             if meshlib.is_initialized() else None}) + "\n")
        sys.stderr.flush()
        yield summary["process_index"]
    finally:
        if joined:
            import torch.distributed as dist
            dist.destroy_process_group()
        for key, value in saved.items():
            if value is None:
                config.unset(key)
            else:
                config.set(key, value)


def build_pod_argv(args, passthrough: List[str]) -> List[List[str]]:
    """One ``ssh HOST 'cd APP && python -m mmlspark_tpu_torch.cli run
    SCRIPT --hosts ... --process-id I'`` argv a host: host ``I`` of
    ``--hosts`` is rank ``I``, host 0 the rendezvous (``cli run``'s
    ``--hosts`` rules). Split out so the constructed argv is tested
    without a cluster."""
    import re
    import shlex

    def quote_dir(p: str) -> str:
        # a leading ~ (bare, ~/path or ~user/path) stays outside the
        # quotes, or the remote shell never expands it; the unquoted
        # prefix must have a user name's shape, else all is quoted
        if p.startswith("~"):
            prefix, sep, rest = p.partition("/")
            if re.fullmatch(r"~[A-Za-z0-9._-]*", prefix):
                if not sep:
                    return prefix
                return prefix + "/" + (shlex.quote(rest) if rest else "")
        return shlex.quote(p)

    hosts = [h.strip() for h in args.hosts.split(",") if h.strip()]
    if not hosts:
        raise SystemExit("launch-pod: empty host list")
    out = []
    for i, host in enumerate(hosts):
        inner = ["python", "-m", "mmlspark_tpu_torch.cli", "run",
                 args.script, "--hosts", ",".join(hosts),
                 "--process-id", str(i)]
        if args.mesh:
            inner += ["--mesh", args.mesh]
        if passthrough:
            inner += ["--"] + list(passthrough)
        out.append(["ssh", host, "cd " + quote_dir(args.app_dir) + " && "
                    + " ".join(shlex.quote(a) for a in inner)])
    return out


def cmd_launch_pod(args, passthrough: List[str]) -> int:
    """Start ``run SCRIPT`` on every host over ssh and wait for them all;
    the first non-zero exit code, else 0. ``--dry-run`` prints the argv
    list as JSON and runs nothing."""
    if args.mesh:
        from mmlspark_tpu_torch.parallel.mesh import parse_mesh_axes
        try:
            parse_mesh_axes(args.mesh)   # fail before contacting a host
        except ValueError as e:
            raise SystemExit(f"--mesh: {e}")
    argvs = build_pod_argv(args, passthrough)
    if args.dry_run:
        print(json.dumps(argvs))  # lint: allow-print
        return 0
    import subprocess
    procs = [subprocess.Popen(a) for a in argvs]  # lint: allow-process (launch-pod owns its ssh children)
    codes = [p.wait() for p in procs]
    return next((c for c in codes if c), 0)


def cmd_report(args, passthrough) -> int:
    """The run report of one or more event logs (per-process sidecars
    merge; ``--glob`` adds a pattern); ``--json`` prints the structured
    form, ``--trace`` also exports a Chrome trace of one log."""
    from mmlspark_tpu_torch.observability.aggregate import expand_event_paths
    paths = expand_event_paths(args.events, args.glob or None)
    if not paths:
        raise SystemExit("report: no event logs matched")
    target = paths[0] if len(paths) == 1 else paths
    if args.trace:
        if len(paths) > 1:
            raise SystemExit("--trace exports one log at a time; pass a "
                             "single events path")
        from mmlspark_tpu_torch.observability.trace import export_trace
        stats = export_trace(paths[0], args.trace)
        print(f"trace: {stats['out']} ({stats['spans']} spans, "  # lint: allow-print
              f"{stats['events']} events, {stats['tracks']} tracks) — "
              "open in https://ui.perfetto.dev")
    if args.json:
        from mmlspark_tpu_torch.observability.report import build_report
        print(json.dumps(build_report(target, top=args.top), sort_keys=True))  # lint: allow-print
    else:
        from mmlspark_tpu_torch.observability.report import render_report
        print(render_report(target, top=args.top))  # lint: allow-print
    return 0


def cmd_info(args, passthrough) -> int:
    import torch

    from mmlspark_tpu_torch.parallel.mesh import device_count_summary
    from mmlspark_tpu_torch.utils import config
    cuda = torch.cuda.is_available()
    info = {"devices": device_count_summary(),
            "platform": "gpu" if cuda else "cpu",
            "count": torch.cuda.device_count() if cuda else 0,
            "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
            "torch": torch.__version__, "cuda": torch.version.cuda,
            "config": config.snapshot()}
    print(json.dumps(info, indent=2, default=str))  # lint: allow-print
    return 0


def cmd_check(args, passthrough) -> int:
    """Static reliability lint over the installed package, or explicit
    roots."""
    from mmlspark_tpu_torch.reliability import lint
    roots = args.roots or [os.path.dirname(
        os.path.abspath(__import__("mmlspark_tpu_torch").__file__))]
    return lint.main(roots)


def cmd_top(args, passthrough) -> int:
    """Live fleet dashboard over HTTP replicas: scrapes ``/metrics`` +
    ``/readyz`` from every --replica through per-host circuit breakers
    and redraws a plain-ANSI frame. ``--once`` prints a single frame."""
    from mmlspark_tpu_torch.observability.aggregate import FleetScraper
    from mmlspark_tpu_torch.observability.dashboard import TopDashboard
    from mmlspark_tpu_torch.observability.slo import SloEngine
    from mmlspark_tpu_torch.serve.router import HttpReplica
    if not args.replica:
        raise SystemExit("top: at least one --replica HOST:PORT required")
    replicas = [HttpReplica(addr) for addr in args.replica]
    scraper = FleetScraper(replicas, timeout_s=args.timeout)
    dash = TopDashboard(scraper, SloEngine(), interval_s=args.interval)
    dash.run(once=args.once)
    return 0


def cmd_chaos(args, passthrough) -> int:
    """Seeded chaos scenario (``reliability/chaos.py``): ``train``
    (default), ``fleet``, ``decode``, ``fleetprefix``, ``host``,
    ``autopilot``, ``elastic``, and the mesh-bound ``fleet_sharded``,
    ``decode_sharded``, ``recommender`` and ``reshard``, which run on
    ``--nprocs`` local ranks (default 2): rank 0 leads and runs the
    scenario, the others follow (``parallel/leader.py``), over gloo
    where NCCL cannot give each rank a card of its own (the CPU, or
    ranks sharing a card) unless ``runtime.dist_backend`` is set. Rank 0
    writes ``chaos_verdict.json`` under --out and prints it; exit 0 iff
    every invariant held."""
    from mmlspark_tpu_torch.reliability import chaos
    if args.scenario not in chaos.SCENARIOS:
        known = "\n".join(f"  {name:14s} {desc}" for name, desc
                          in sorted(chaos.SCENARIOS.items()))
        print(f"chaos: unknown scenario {args.scenario!r}; "  # lint: allow-print
              f"registered scenarios:\n{known}", file=sys.stderr)
        return 2
    meshed = args.scenario in chaos.MESH_SCENARIOS
    if (args.nprocs or args.platform) and not meshed:
        raise SystemExit(f"--nprocs and --platform are for the mesh-bound "
                         f"scenarios {list(chaos.MESH_SCENARIOS)}, not "
                         f"{args.scenario!r} (it runs on runtime.device)")
    outdir = os.path.abspath(args.out or os.path.join(
        os.getcwd(), f"chaos-{args.scenario}-seed{args.seed}"))
    if meshed and args.process_id is None:
        n = args.nprocs or 2
        return _run_local_ranks(
            n, lambda rank, coordinator: _chaos_rank_argv(
                args, outdir, rank, coordinator, n),
            env=_chaos_backend(args.platform, n))
    from mmlspark_tpu_torch.parallel import leader
    with _in_group(args) if meshed else contextlib.nullcontext(0) as rank:
        if rank:
            leader.follow()
            return 0
        with leader.lead() if meshed else contextlib.nullcontext():
            verdict = chaos.run_named(
                args.scenario, args.seed, outdir, replicas=args.replicas,
                requests=args.requests, total_steps=args.steps,
                save_every=args.save_every)
    # stdout contract: the verdict JSON, so wrappers don't re-read the file
    print(json.dumps(verdict, indent=2,       # lint: allow-print
                     sort_keys=True))
    return 0 if verdict["passed"] else 1


def _chaos_rank_argv(args, outdir: str, rank: int, coordinator: str,
                     n: int) -> List[str]:
    """One rank's ``chaos`` command line under ``--nprocs``."""
    argv = ["chaos", "--scenario", args.scenario, "--seed", str(args.seed),
            "--out", outdir, "--requests", str(args.requests),
            "--replicas", str(args.replicas), "--coordinator", coordinator,
            "--num-processes", str(n), "--process-id", str(rank)]
    if args.platform:
        argv += ["--platform", args.platform]
    return argv


def _chaos_backend(platform: Optional[str], n: int) -> dict:
    """The ranks' ``runtime.dist_backend`` when none is set: gloo where
    NCCL cannot give each of the ``n`` ranks a card of its own (the CPU,
    or ranks sharing a card), else the configured default."""
    from mmlspark_tpu_torch.utils import config
    key = config._env_key("runtime.dist_backend")
    if key in os.environ or "runtime.dist_backend" in config._overrides:
        return {}
    device = platform or str(config.get("runtime.device"))
    if not device.startswith("cuda"):
        return {key: "gloo"}
    import torch
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return {key: "gloo"} if cards < n else {}



def cmd_bench(args, passthrough) -> int:
    """``./bench.py`` of the working directory (``--baseline`` passed on,
    as the reference's command does), its stdout echoed; with a baseline
    the first bench line (a JSON object with ``configs``) is gated through
    the port's benchgate and the verdict printed last."""
    import subprocess

    from mmlspark_tpu_torch.observability import benchgate
    path = os.path.join(os.getcwd(), "bench.py")
    if not os.path.exists(path):
        raise SystemExit("no bench.py in the current directory")
    extra = ["--baseline", args.baseline] if args.baseline else []
    proc = subprocess.run([sys.executable, path] + extra + passthrough,
                          capture_output=True, text=True)
    sys.stderr.write(proc.stderr)
    print(proc.stdout, end="")  # lint: allow-print
    if proc.returncode != 0 or not args.baseline:
        return proc.returncode
    line = None
    for text in proc.stdout.splitlines():
        try:
            obj = json.loads(text)
        except ValueError:
            continue
        if isinstance(obj, dict) and isinstance(obj.get("configs"), dict):
            line = obj
            break
    if line is None:
        raise SystemExit("bench: bench.py printed no bench line to gate")
    verdict = benchgate.gate(line, args.baseline)
    print(json.dumps(verdict, sort_keys=True))  # lint: allow-print
    return 0 if verdict["green"] else 1


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="mmlspark-tpu-torch",
        description="serving, process fleet and load tools of the PyTorch "
                    "port")
    sub = parser.add_subparsers(dest="command", required=True)

    serve_p = sub.add_parser(
        "serve",
        help="serve models over HTTP with dynamic micro-batching")
    serve_p.add_argument("--model", action="append", default=[],
                         metavar="NAME=ARCH[:JSON-kwargs]",
                         help="register a model under NAME (repeatable), "
                         'e.g. mlp=mlp_tabular:{"input_dim": 8}')
    serve_p.add_argument("--host", default="127.0.0.1")
    serve_p.add_argument("--port", type=int, default=8080,
                         help="0 = pick an ephemeral port (announced on "
                         "stdout)")
    serve_p.add_argument("--max-batch", type=int, default=None,
                         help="rows per micro-batch (serving.max_batch)")
    serve_p.add_argument("--max-wait-ms", type=float, default=None,
                         help="max coalescing wait (serving.max_wait_ms)")
    serve_p.add_argument("--queue-depth", type=int, default=None,
                         help="admission queue bound (serving.queue_depth)")
    serve_p.add_argument("--buckets", default="",
                         help='batch-shape buckets, e.g. "1,8,64" '
                         "(serving.buckets)")
    serve_p.add_argument("--replicas", type=int, default=1,
                         help="in-process serving replicas behind the "
                         "fleet router (failover, health probing, "
                         "rolling rollout; default 1 = plain server)")
    serve_p.add_argument("--autopilot", action="store_true",
                         help="run the SLO-driven autopilot over the "
                         "fleet (traffic shift, replica scale, adaptive "
                         "admission; needs --replicas > 1). Also on when "
                         "autopilot.enabled is set")
    serve_p.add_argument("--events-dir", default="",
                         help="write this process's telemetry to "
                         "EVENTS_DIR/events-<pid>.jsonl (the per-pid "
                         "sidecar convention)")
    serve_p.set_defaults(fn=cmd_serve)

    fleet_p = sub.add_parser(
        "fleet",
        help="launch N `serve` worker PROCESSES behind the router, "
             "supervised with restart-on-crash (backoff + breaker); "
             "SIGTERM drains every child")
    fleet_p.add_argument("--model", action="append", default=[],
                         metavar="NAME=ARCH[:JSON-kwargs]",
                         help="model spec forwarded to every worker "
                         "(repeatable)")
    fleet_p.add_argument("--host", default="127.0.0.1")
    fleet_p.add_argument("--port", type=int, default=8080,
                         help="front router port (0 = ephemeral, "
                         "announced on stdout); workers always bind "
                         "ephemeral ports")
    fleet_p.add_argument("--replicas", type=int, default=None,
                         help="worker process count (default: "
                         "fleet.replicas config)")
    fleet_p.add_argument("--events-dir", default="",
                         help="shared telemetry directory: every process "
                         "(workers AND supervisor) appends its own "
                         "events-<pid>.jsonl there (default "
                         "./fleet-events)")
    fleet_p.add_argument("--compile-cache-dir", default="",
                         help="compile-cache root exported to every "
                         "worker (default: runtime.compile_cache_dir)")
    fleet_p.add_argument("--devices-per-worker", type=int, default=None,
                         help="pin each worker to K disjoint cards (slot i "
                         "sees cards [i*K, (i+1)*K) via "
                         "CUDA_VISIBLE_DEVICES); 0 = no pinning, workers "
                         "share the card(s), each with its own CUDA "
                         "context (default: fleet.devices_per_worker)")
    fleet_p.add_argument("--hosts", default="",
                         help="comma list of hosts to fan one fleet out "
                         "to each ('local' runs on this machine, other "
                         "names go over ssh); the announced host fronts "
                         "are stitched behind one router here (default: "
                         "fleet.hosts config; empty = single host)")
    fleet_p.add_argument("--hosts-file", default="",
                         help="file with one host per line (# comments); "
                         "mutually exclusive with --hosts")
    fleet_p.add_argument("--autopilot", action="store_true",
                         help="run the SLO-driven autopilot with the "
                         "scale lever actuating real worker processes "
                         "(Supervisor.add_slot/retire_slot; single-host "
                         "mode only; also on when autopilot.enabled is "
                         "set — see autopilot.scale_backend)")
    fleet_p.set_defaults(fn=cmd_fleet)

    autopilot_p = sub.add_parser(
        "autopilot",
        help="autopilot offline tooling (counterfactual policy replay "
             "over recorded decision telemetry)")
    ap_sub = autopilot_p.add_subparsers(dest="subcommand", required=True)
    replay_p = ap_sub.add_parser(
        "replay",
        help="re-run the pure decide() core over recorded "
             "autopilot_signals events; verify byte-identical fidelity "
             "under the recorded policy and rank candidate threshold "
             "overrides by counterfactual shed/SLO/action outcome")
    replay_p.add_argument("events", nargs="+",
                          help="event JSONL path(s) from a recorded "
                          "autopilot run (per-pid/per-host sidecars "
                          "merge)")
    replay_p.add_argument("--candidate", action="append", default=[],
                          metavar="LABEL:KEY=VAL[,KEY=VAL...]",
                          help="candidate policy: recorded thresholds "
                          "with these overrides (repeatable), e.g. "
                          "eager:scale_up_queue=2,scale_cooldown_s=10")
    replay_p.add_argument("--json", action="store_true",
                          help="emit fidelity + ranking as one JSON "
                          "object instead of the table")
    replay_p.set_defaults(fn=cmd_autopilot)

    loadgen_p = sub.add_parser(
        "loadgen", help="preview a seeded open-loop workload schedule")
    loadgen_p.add_argument("--rate", type=float, default=8.0,
                           help="base arrivals/second (default 8)")
    loadgen_p.add_argument("--duration", type=float, default=10.0,
                           help="trace length in seconds (default 10)")
    loadgen_p.add_argument("--shape", default="constant",
                           choices=["constant", "diurnal", "spike"],
                           help="rate curve (default constant)")
    loadgen_p.add_argument("--process", default="poisson",
                           choices=["poisson", "pareto"],
                           help="arrival process (default poisson)")
    loadgen_p.add_argument("--spike-start", type=float, default=0.0,
                           help="spike window start (s)")
    loadgen_p.add_argument("--spike-len", type=float, default=0.0,
                           help="spike window length (s)")
    loadgen_p.add_argument("--spike-factor", type=float, default=1.0,
                           help="rate multiplier inside the spike window")
    loadgen_p.add_argument("--pareto-alpha", type=float, default=1.5,
                           help="pareto tail shape (must be > 1)")
    loadgen_p.add_argument("--session-turns", type=int, default=1,
                           help="max turns per session (default 1: no "
                           "sessions)")
    loadgen_p.add_argument("--think", type=float, default=0.0,
                           help="inter-turn think time (s)")
    loadgen_p.add_argument("--seed", type=int, default=0,
                           help="schedule seed (default 0)")
    loadgen_p.add_argument("--bucket", type=float, default=1.0,
                           help="bucket size for per-bucket counts "
                           "(default 1s; 0 disables)")
    loadgen_p.add_argument("--json", action="store_true",
                           help="emit the preview as one JSON object")
    loadgen_p.set_defaults(fn=cmd_loadgen)

    run_p = sub.add_parser("run", help="run a script in the process group")
    run_p.add_argument("script")
    run_p.add_argument("--mesh", default="",
                       help="axis sizes, e.g. data=-1,tensor=2 (-1 absorbs)")
    run_p.add_argument("--coordinator", default=None,
                       help="host:port of rank 0's rendezvous")
    run_p.add_argument("--num-processes", type=int, default=None)
    run_p.add_argument("--process-id", type=int, default=None)
    run_p.add_argument("--hosts", default="",
                       help="comma list of participating hosts; run the "
                       "same command on every host and each derives its "
                       "process id, with host 0 as coordinator")
    run_p.add_argument("--port", type=int, default=8476,
                       help="coordinator port used with --hosts")
    run_p.add_argument("--platform", default=None, choices=["cpu", "cuda"],
                       help="the device each rank computes on "
                       "(runtime.device); cuda takes card local_rank %% "
                       "device_count")
    run_p.add_argument("--nprocs", type=int, default=0,
                       help="start this many ranks on this host and wait "
                       "for them")
    run_p.set_defaults(fn=cmd_run)

    pod_p = sub.add_parser(
        "launch-pod", help="run a script on every host of a pod over ssh")
    pod_p.add_argument("hosts", help="comma list of hosts; host 0 is the "
                       "rendezvous and rank 0")
    pod_p.add_argument("script", help="script path on the hosts")
    pod_p.add_argument("--mesh", default="",
                       help="forwarded to `run` on each host")
    pod_p.add_argument("--app-dir", default="~/app",
                       help="directory cd'd into on each host")
    pod_p.add_argument("--dry-run", action="store_true",
                       help="print the per-host argv as JSON, run nothing")
    pod_p.set_defaults(fn=cmd_launch_pod)

    report_p = sub.add_parser(
        "report", help="render a run report from event log(s)")
    report_p.add_argument("events", nargs="*",
                          help="events.jsonl path(s) or flight-recorder "
                          "dumps; per-process sidecars merge (may be "
                          "omitted when --glob is given)")
    report_p.add_argument("--glob", default="",
                          help="also merge every log matching this glob")
    report_p.add_argument("--top", type=int, default=10,
                          help="rows in the slowest-span table (default 10)")
    report_p.add_argument("--trace", default="",
                          help="also export a Chrome-trace JSON timeline "
                          "to this path")
    report_p.add_argument("--json", action="store_true",
                          help="print the structured report as one JSON "
                          "object")
    report_p.set_defaults(fn=cmd_report)

    info_p = sub.add_parser("info", help="device + config inventory")
    info_p.set_defaults(fn=cmd_info)

    bench_p = sub.add_parser("bench", help="run ./bench.py")
    bench_p.add_argument("--baseline", default="",
                         help="committed bench JSON to gate against: "
                         "per-lane regression thresholds, verdict on "
                         "stdout, exit nonzero on red")
    bench_p.set_defaults(fn=cmd_bench)

    check_p = sub.add_parser(
        "check", help="static reliability lint (timeouts, swallowed "
                      "excepts, unbounded queues, raw syncs)")
    check_p.add_argument("roots", nargs="*",
                         help="files/dirs to lint (default: the installed "
                         "mmlspark_tpu_torch package)")
    check_p.set_defaults(fn=cmd_check)

    chaos_p = sub.add_parser(
        "chaos", help="seeded chaos scenario; exits 0 iff all invariants "
                      "hold")
    chaos_p.add_argument("--scenario", default="train",
                         help="train, fleet, decode, fleetprefix, host, "
                         "autopilot or elastic; on --nprocs ranks "
                         "fleet_sharded, decode_sharded, recommender or "
                         "reshard (default: train; unknown scenarios list "
                         "the registry and exit 2)")
    chaos_p.add_argument("--seed", type=int, default=0,
                         help="fault-schedule seed (same seed => same "
                         "kills, same verdict)")
    chaos_p.add_argument("--out", default="",
                         help="verdict/checkpoint directory (default "
                         "./chaos-<SCENARIO>-seed<SEED>)")
    chaos_p.add_argument("--steps", type=int, default=8,
                         help="train steps in each run (default 8)")
    chaos_p.add_argument("--save-every", type=int, default=2,
                         help="checkpoint cadence in steps (default 2)")
    chaos_p.add_argument("--requests", type=int, default=12,
                         help="serve-phase request count (default 12)")
    chaos_p.add_argument("--replicas", type=int, default=3,
                         help="fleet width for fleet/decode/fleetprefix/"
                         "autopilot and the mesh-bound scenarios; "
                         "worker-process count for host/elastic "
                         "(default 3)")
    chaos_p.add_argument("--nprocs", type=int, default=0,
                         help="local ranks of a mesh-bound scenario "
                         "(default 2; rank 0 leads)")
    chaos_p.add_argument("--platform", default=None, choices=["cpu", "cuda"],
                         help="the device each rank of a mesh-bound "
                         "scenario computes on (runtime.device); cuda "
                         "takes card local_rank %% device_count")
    # a rank's place in the group, given by the --nprocs launcher
    chaos_p.add_argument("--coordinator", default=None,
                         help=argparse.SUPPRESS)
    chaos_p.add_argument("--num-processes", type=int, default=None,
                         help=argparse.SUPPRESS)
    chaos_p.add_argument("--process-id", type=int, default=None,
                         help=argparse.SUPPRESS)
    chaos_p.set_defaults(fn=cmd_chaos)

    top_p = sub.add_parser(
        "top", help="live fleet dashboard (scrapes /metrics + /readyz)")
    top_p.add_argument("--replica", action="append", default=[],
                       metavar="HOST:PORT",
                       help="replica address to scrape (repeatable)")
    top_p.add_argument("--interval", type=float, default=2.0,
                       help="redraw interval in seconds (default 2)")
    top_p.add_argument("--once", action="store_true",
                       help="print one frame and exit (tests/CI)")
    top_p.add_argument("--timeout", type=float, default=2.0,
                       help="per-replica scrape timeout in seconds")
    top_p.set_defaults(fn=cmd_top)
    return parser


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    # split off worker passthrough args after `--`
    passthrough: List[str] = []
    if "--" in argv:
        cut = argv.index("--")
        argv, passthrough = argv[:cut], argv[cut + 1:]
    args = build_parser().parse_args(argv)
    try:
        return args.fn(args, passthrough)
    except Exception:
        # the ring goes to disk before the crash propagates, so it ships
        # its own context even where no events path was set
        from mmlspark_tpu_torch.observability import flightrec
        dumped = flightrec.dump(reason="crash")
        if dumped:
            print(f"flight recorder dumped to {dumped}", file=sys.stderr)  # lint: allow-print
        raise


if __name__ == "__main__":
    sys.exit(main())
