"""Whole-pipeline device-memory planner — static OOM prediction
(counterpart of the JAX package's ``analysis/memplan.py``).

Composes the per-filter program costs (analysis/costmodel.py) with the
pipeline-level in-flight state the runtime parks on the device:

- **params**, counted ONCE per backend instance — filters sharing a
  ``shared-tensor-filter-key`` share one loaded model, so N sharers must
  not bill N×params — and beside them, once per backend too, the
  **derived** weights the forward keeps (the BN-folded, cast copies,
  costmodel ``derived_bytes``); on the card both as the allocator may
  count them after earlier work (``weight_rounding_bytes_total``:
  512-byte blocks, and up to 1 MiB more for a weight above 1 MiB that a
  cached block serves whole, costmodel ``held_block_bytes``);
- **upload window** (``feed-depth=N``): up to N assembled micro-batches
  of inputs in flight on the device before the oldest invokes;
- **program peak**: the invoke's own live-activation peak;
- **fetch window** (``fetch-window=K|auto|eos``): up to K invokes'
  outputs held on the device awaiting the batched fetch (``auto`` is
  bounded by its saturated-regime constant, ``eos`` by the
  ``_EOS_WINDOW_CAP`` backstop);
- **steady-loop window ring** (``loop-window=N`` + ``launch-depth=K``):
  up to K in-flight windows, each holding its staged N-frame input ring
  and its stacked outputs awaiting the drain (billed only where the loop
  actually engages — an ineligible or over-budget window falls back
  per-buffer at PLAYING and bills nothing; multiple looped filters
  resolve jointly, first-in-graph-order wins the budget). Where the
  window runs as a CUDA graph (a backend on the card), the graph's
  private memory pool is billed too: what one capture keeps alive, as
  the card's allocator counts it, which is one composition's activation
  peak (the pool hands the blocks a row frees to the next row within the
  capture) beside the earlier rows' outputs (:func:`graph_pool_bytes`);
  and where the composition runs a product, cuBLAS's workspace, which
  the first capture's products take in its pool and keep;
- **mesh partition** (``shard=dp|tp|dpxtp mesh=AxB``, analysis/shard.py):
  an ENGAGED shard bills per mesh POSITION — inputs/outputs/activations
  split their batch rows over the dp axis, params split channel dims
  over tp and replicate over dp; under tp each dp row's computing device
  also holds, for the length of an invoke, the leaves it gathers and
  their folded copies. A refused shard bills single-device, never the
  ask;
- **replica pool** (``replicas=N``, analysis/pool.py): every replica holds
  its own params, folded weights and serving batch on its device;
- **queues on memory:HBM edges**: a bounded queue on a device-resident
  edge parks up to max-size-buffers device payloads (billed at the
  element's runtime default of 16 when unset; skipped when the edge caps
  cannot resolve statically);
- **serving tier** (``tensor_query_serversrc serve=1``): the padded
  micro-batch (serve-batch rows x the per-request caps bytes) plus the
  bounded admission queue's held requests.

Every holding lands on a device of ``parallel/mesh.visible_devices()``:
an unsharded filter, queue or server on the first, the positions of a
mesh or a pool on theirs. Where a mesh or a pool repeats a device (a
mesh of virtual devices over one card), that device's sum counts every
position and replica on it (``per_device_bytes``). The plan's total is
the BINDING per-device footprint, the largest such sum — with distinct
devices, the first device's, as in the JAX package — checked against the
per-device budget: ``NNSTPU_HBM_BYTES``, else the card's memory
(``torch.cuda.mem_get_info``), else the JAX package's default (16 GiB)
under its own label, so CPU verdicts match the JAX package's; over a
mesh or a pool the smallest of its devices' budgets.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

from nnstreamer_tpu_torch.analysis.costmodel import (
    DEFAULT_HBM_BYTES,
    card_block_bytes,
    cublas_workspace_bytes,
    filter_cost,
)

#: fraction of the budget above which NNST703 warns
NEAR_BUDGET_FRACTION = 0.8


def device_memory_budget(device_index: int = 0) -> Tuple[int, str]:
    """(bytes, source) of one device's budget: the NNSTPU_HBM_BYTES
    override, else the CUDA card's total memory, else the JAX package's
    default."""
    env = os.environ.get("NNSTPU_HBM_BYTES")
    if env:
        try:
            return _parse_bytes(env), "NNSTPU_HBM_BYTES"
        except ValueError:
            # a malformed override must not crash a plan: fall through
            pass
    import torch

    if torch.cuda.is_available() and device_index < torch.cuda.device_count():
        return int(torch.cuda.mem_get_info(device_index)[1]), "cuda"
    return DEFAULT_HBM_BYTES, "default-v5e"


def _budget_of(dev) -> Tuple[int, str]:
    """:func:`device_memory_budget` of one ``torch.device``: a CUDA
    device's own, any other device the default's."""
    index = (dev.index or 0) if getattr(dev, "type", "") == "cuda" else 1 << 30
    return device_memory_budget(index)


def mesh_memory_budget(n_devices: int) -> Tuple[int, str]:
    """The BINDING per-device budget over the first ``n_devices`` visible
    devices a mesh or a pool spans: the minimum of their budgets. With one
    device this is exactly :func:`device_memory_budget`."""
    devs = _plan_devices(max(1, int(n_devices)))
    best: Optional[Tuple[int, str]] = None
    for dev in devs[:max(1, int(n_devices))]:
        b, src = _budget_of(dev)
        if best is None or b < best[0]:
            best = (b, src if n_devices <= 1 else f"{src}:min-of-"
                    f"{n_devices}-devices")
    return best


def _plan_devices(n: int) -> List[Any]:
    """The first ``n`` visible devices (at least one), padded with named
    placeholders where fewer are visible (an ineligible ask the analyzers
    refuse, billed all the same)."""
    from nnstreamer_tpu_torch.parallel.mesh import visible_devices

    try:
        devs = list(visible_devices())
    except ValueError:  # a malformed NNSTPU_TORCH_DEVICES
        devs = []
    if not devs:
        import torch

        devs = [torch.device("cpu")]
    return devs + [f"device#{i}" for i in range(len(devs), n)]


def _parse_bytes(s: str) -> int:
    s = s.strip().upper()
    mult = 1
    for suffix, m in (("K", 2**10), ("M", 2**20), ("G", 2**30),
                      ("T", 2**40)):
        if s.endswith(suffix):
            s, mult = s[:-1], m
            break
    return int(float(s) * mult)


def _edge_bytes_resolver(pipeline):
    """Shared caps→bytes resolution (live pad caps, else the dry-run
    negotiation)."""
    from nnstreamer_tpu_torch.analysis.residency import _Predictor

    return _Predictor(pipeline, 1, "host")


def plan_memory(pipeline, method: str = "auto",
                cost_override: Optional[Dict[str, Any]] = None,
                loop_override: Optional[Dict[str, Tuple[int, int]]] = None,
                replica_override: Optional[Dict[str, int]] = None
                ) -> Dict[str, Any]:
    """The whole-pipeline device-memory plan: rows per device-capable
    filter, HBM-edge queue holdings, serving holdings, the shared-deduped
    param total, the grand total and the budget.

    ``cost_override`` maps element name → cost dict (or None): the chain
    analyzer (analysis/chain.py) plans a PROSPECTIVE whole-chain fusion
    by replacing the chain members' rows with ONE composed row on the
    head (a cost dict with every member's params billed once in its
    ``param_bytes``) and dropping the fused members (None) — the NNST452
    budget verdict before anything runs.

    ``loop_override`` maps element name → (loop-window, launch-depth):
    the loop analyzer (analysis/loop.py) probes a PROSPECTIVE window's
    ring against the budget (the NNST462 verdict / loop-window=auto
    resolution). With an override, only the named elements bill a loop
    ring; without one, each filter bills the window the RUNTIME will
    engage (``runtime_loop_config``).

    ``replica_override`` maps element name → replica count N: the pool
    analyzer (analysis/pool.py) probes a PROSPECTIVE replica pool against
    the per-device budget (the NNST962 verdict / ``replicas=auto``).
    Without one, each filter bills the count the RUNTIME will engage
    (``runtime_filter_replicas``). Replica billing is the opposite of a
    dp shard's: params and the serving batch REPLICATE per device."""
    from nnstreamer_tpu_torch.elements.basic import QueueElement
    from nnstreamer_tpu_torch.elements.filter import TensorFilter
    from nnstreamer_tpu_torch.pipeline.planner import _plan_residency

    all_src = [sp for e in pipeline.elements.values() for sp in e.src_pads]
    if all_src and all(sp.device_ok is None for sp in all_src):
        _plan_residency(pipeline)

    sizes = _edge_bytes_resolver(pipeline)
    rows: List[Dict[str, Any]] = []
    unmodeled: List[str] = []
    param_groups: Dict[Any, int] = {}
    derived_groups: Dict[Any, int] = {}
    #: on the card: the allocator's blocks around a group's weights
    rounding_groups: Dict[Any, int] = {}
    #: the device positions each param group is held at (one per mesh
    #: position or replica)
    group_positions: Dict[Any, List[Any]] = {}
    #: per device: the rows' holdings and the transient tp gathers
    per_device: Dict[str, int] = {}
    mesh_devices = 1  # widest mesh or pool any row engages (budget span)
    dev0 = str(_plan_devices(1)[0])

    def hold(dev, nbytes: int) -> None:
        per_device[str(dev)] = per_device.get(str(dev), 0) + int(nbytes)

    for e in pipeline.elements.values():
        if not isinstance(e, TensorFilter) or not e._fw_device_capable():
            continue
        if cost_override is not None and e.name in cost_override:
            cost = cost_override[e.name]
            if cost is None:
                continue  # fused chain member: billed by its head's row
        else:
            # a live chain SHELL still rows here with its solo cost: the
            # head's cost_program is solo too, so head-solo + member-solo
            # rows (params deduped per backend) approximate the composed
            # footprint without double-billing
            cost = filter_cost(e, method=method)
        if cost is None:
            unmodeled.append(e.name)
            continue
        batch = max(1, cost["batch"])
        # per-invoke transfer payloads come from the program's own
        # signature (batch already folded into the shapes)
        per_invoke_in = cost["input_bytes"]
        per_invoke_out = cost["output_bytes"]
        feed = max(1, int(e.properties.get("feed_depth", 1) or 1))
        window = _window_entries(e)
        if loop_override is not None:
            loopw, loopk = loop_override.get(e.name, (1, 1))
        else:
            from nnstreamer_tpu_torch.analysis.loop import runtime_loop_config

            loopw, loopk = runtime_loop_config(pipeline, e)
        # the program's raw peak counts params and the consumed input
        # batch among its live values; params bill ONCE per backend
        # (below) and in-flight inputs via feed_bytes, so the row's own
        # contribution is the ACTIVATION residual
        activation = max(0, cost["peak_live_bytes"] - cost["param_bytes"]
                         - cost["input_bytes"])
        # mesh partition (analysis/shard.py): an ENGAGED shard bills per
        # position, mirroring the runtime fallback exactly (a refused
        # shard bills single-device, never the ask). Shard and
        # loop-window are mutually exclusive by the analyzer's gates.
        from nnstreamer_tpu_torch.analysis.shard import (
            runtime_shard_config,
            shard_billing,
        )

        shard_cfg = runtime_shard_config(pipeline, e)
        shard_bill = shard_billing(pipeline, e) if shard_cfg else None
        shard_dp = int(shard_cfg["dp"]) if shard_bill else 1
        shard_tp = int(shard_cfg["tp"]) if shard_bill else 1
        shard_devices = int(shard_bill["devices"]) if shard_bill else 1
        # replica pool (analysis/pool.py): params and the serving batch
        # REPLICATE on every replica's device
        if replica_override is not None:
            replicas = int(replica_override.get(e.name, 1))
        else:
            from nnstreamer_tpu_torch.analysis.pool import (
                runtime_filter_replicas,
            )

            replicas = runtime_filter_replicas(pipeline, e)
        replicas = max(1, replicas)
        span = max(shard_devices, replicas)
        mesh_devices = max(mesh_devices, span)
        if shard_dp > 1:
            # per-POSITION view: dp splits the batch rows of inputs,
            # outputs and the activation residual evenly (divisibility
            # was the NNST470 proof)
            per_invoke_in //= shard_dp
            per_invoke_out //= shard_dp
            activation //= shard_dp
        loop_bytes = graph_bytes = cublas_bytes = 0
        graph_terms = None
        if loopw > 1:
            # up to launch-depth windows in flight, each holding its
            # staged input ring AND its stacked outputs (the conservative
            # peak). When the loop engages it owns both transfer
            # amortizers: the feed/fetch holdings it bypasses bill zero
            loop_bytes = loopk * loopw * (per_invoke_in + per_invoke_out)
            feed = 1
            window = 0
            if _runs_on_card(e):
                outs = cost.get("output_sizes", [per_invoke_out])
                graph_bytes = graph_pool_bytes(activation, outs, loopw)
                # the first capture's products make cuBLAS's workspace on
                # the capture stream, in that capture's pool, kept for the
                # process: billed beside the pool, which a recapture needs
                # without it
                if cost.get("gemm"):
                    cublas_bytes = cublas_workspace_bytes()
                graph_terms = dict(
                    cost.get("peak_terms", {"storages": activation}),
                    outputs=graph_bytes - activation - GRAPH_CAPTURE_STATE,
                    capture_state=GRAPH_CAPTURE_STATE,
                    cublas_first_capture=cublas_bytes)
        row = {
            "element": e.name,
            "param_bytes": cost["param_bytes"],
            "derived_bytes": cost.get("derived_bytes", 0),
            "peak_live_bytes": cost["peak_live_bytes"],
            "activation_bytes": activation,
            "feed_bytes": feed * per_invoke_in,
            "window_bytes": window * per_invoke_out,
            "loop_bytes": loop_bytes,
            "graph_bytes": graph_bytes,
            "cublas_bytes": cublas_bytes,
            "feed_depth": feed,
            "window_entries": window,
            "loop_window": loopw,
            "launch_depth": loopk,
            "batch": batch,
        }
        if graph_terms is not None:
            row["graph_terms"] = graph_terms
        if shard_bill is not None:
            row["shard"] = dict(shard_cfg)
            row["devices"] = shard_devices
        if replicas > 1:
            row["replicas"] = replicas
            row["devices"] = replicas
        row["total_bytes"] = (row["activation_bytes"] + row["feed_bytes"]
                              + row["window_bytes"] + row["loop_bytes"]
                              + row["graph_bytes"] + row["cublas_bytes"])
        positions = _plan_devices(span)[:span]
        if shard_tp > 1:
            # the gather: each dp row's computing device (its first tp
            # position) holds the whole params and their folded copies
            # for the length of an invoke; nothing folded stays between
            # invokes
            row["gather_bytes"] = cost["param_bytes"] + row["derived_bytes"]
            row["derived_bytes"] = 0
            for i in range(shard_dp):
                hold(positions[i * shard_tp], row["gather_bytes"])
        rows.append(row)
        for dev in positions:
            hold(dev, row["total_bytes"])
        # params counted once per backend INSTANCE: an open shared
        # framework is one object; at lint time the shared key is the
        # best identity proxy. A sharded filter bills its PER-POSITION
        # param bytes (tp-split leaves / tp, the rest replicated); a
        # replica pool its full params on each replica's device
        key = (id(e.fw) if e.fw is not None
               else (e.properties.get("shared_tensor_filter_key")
                     or f"__private__:{e.name}"))
        p_bytes = (shard_bill["param_bytes_per_device"]
                   if shard_bill is not None else cost["param_bytes"])
        if p_bytes > param_groups.get(key, -1):
            param_groups[key] = p_bytes
            group_positions[key] = positions
        derived_groups[key] = max(derived_groups.get(key, 0),
                                  row["derived_bytes"])
        if shard_bill is None and "weight_blocks" in cost:
            rounding_groups[key] = max(
                rounding_groups.get(key, 0), cost["weight_blocks"]
                - cost["param_bytes"] - cost.get("derived_bytes", 0))

    serving_rows = _serving_holdings(pipeline)

    queue_rows = []
    for e in pipeline.elements.values():
        if not isinstance(e, QueueElement):
            continue
        sp = e.src_pads[0] if e.src_pads else None
        if sp is None or not getattr(sp, "device_resident", False):
            continue
        # QueueElement's runtime default depth (16)
        cap = int(e.properties.get("max_size_buffers", 16) or 0)
        if cap <= 0:
            continue  # unbounded: not a finite holding
        b = sizes.pad_bytes(sp)
        if b is None:
            continue
        queue_rows.append({"element": e.name, "capacity": cap,
                           "bytes": cap * b})

    param_total = sum(param_groups.values())
    derived_total = sum(derived_groups.values())
    for key, positions in group_positions.items():
        for dev in positions:
            hold(dev, param_groups[key] + derived_groups.get(key, 0)
                 + rounding_groups.get(key, 0))
    hold(dev0, sum(q["bytes"] for q in queue_rows)
         + sum(s["bytes"] for s in serving_rows))
    # the plan's total is the BINDING per-device footprint: the largest
    # device's sum (with distinct devices, the first device's, which
    # carries every unsharded holding plus its shard of every sharded
    # one). ``aggregate_bytes`` is every device's sum, informational
    total = max(per_device.values()) if per_device else 0
    budget, budget_src = mesh_memory_budget(mesh_devices)
    out = {
        "rows": rows,
        "queues": queue_rows,
        "serving": serving_rows,
        "param_bytes_total": param_total,
        "param_sharing_groups": len(param_groups),
        "derived_bytes_total": derived_total,
        "weight_rounding_bytes_total": sum(rounding_groups.values()),
        "total_bytes": total,
        "budget_bytes": budget,
        "budget_source": budget_src,
        "utilization": (total / budget) if budget else 0.0,
        "unmodeled": unmodeled,
    }
    if mesh_devices > 1:
        out["mesh_devices"] = mesh_devices
        out["aggregate_bytes"] = sum(per_device.values())
        out["per_device_bytes"] = dict(per_device)
    return out


#: what ``capture_begin`` allocates in the pool before the window runs:
#: the default CUDA generator's philox seed and offset, one int64 each
GRAPH_CAPTURE_STATE = 2 * card_block_bytes(8)


def graph_pool_bytes(activation: int, out_sizes: Sequence[int],
                     window: int) -> int:
    """The bill of a window's CUDA-graph pool: what one capture keeps
    alive, as the card's allocator counts it. The rows of a window run
    one after another inside the capture, and the private pool hands the
    blocks one row frees to the next (best fit: the same blocks), so the
    pool holds the capture's state, then the larger of two moments: the
    last row's activation peak beside the outputs of the rows before it,
    and the window's end, every row's outputs beside their stack.
    ``out_sizes``: the bytes of each output of one row."""
    outs = sum(card_block_bytes(n) for n in out_sizes)
    stacked = sum(card_block_bytes(window * n) for n in out_sizes)
    return int(GRAPH_CAPTURE_STATE
               + max(activation + (window - 1) * outs,
                     window * outs + stacked))


def _runs_on_card(e) -> bool:
    """Does this filter's backend run on the card? The open backend's
    device, else its ``accelerator`` property, which means the card
    unless it asks for the CPU."""
    from nnstreamer_tpu_torch.filters.cuda_filter import wants_cpu

    dev = getattr(e.fw, "_device", None) if e.fw is not None else None
    if dev is not None:
        return dev.type == "cuda"
    return not wants_cpu(str(e.properties.get("accelerator", "") or ""))


def _serving_holdings(pipeline) -> List[Dict[str, Any]]:
    """Per ``serve=1`` query server: the padded micro-batch under assembly
    (serve-batch rows) plus the bounded admission queue's held requests,
    both at the per-REQUEST caps bytes."""
    from nnstreamer_tpu_torch.analysis.residency import caps_nbytes
    from nnstreamer_tpu_torch.caps import Caps
    from nnstreamer_tpu_torch.elements.query import TensorQueryServerSrc

    out: List[Dict[str, Any]] = []
    for e in pipeline.elements.values():
        if not isinstance(e, TensorQueryServerSrc) \
                or not e.properties.get("serve"):
            continue
        caps_s = str(e.properties.get("caps", "") or "")
        unit = caps_nbytes(Caps.from_string(caps_s)) if caps_s else None
        if unit is None:
            continue  # flexible/missing caps: serving refuses at start()
        batch = max(1, int(e.properties.get("serve_batch", 1) or 1))
        # the scheduler's runtime default depth (64); an explicit <= 0 is
        # unbounded, not a finite holding this plan can bill
        depth_prop = e.properties.get("serve_queue_depth", 64)
        depth = int(depth_prop if depth_prop is not None else 64)
        queue_bytes = depth * unit if depth > 0 else 0
        out.append({
            "element": e.name,
            "serve_batch": batch,
            "queue_depth": depth,
            "unit_bytes": unit,
            "batch_bytes": batch * unit,
            "queue_bytes": queue_bytes,
            "bytes": batch * unit + queue_bytes,
        })
    return out


def fetch_window_size(e) -> int:
    """A filter's configured fetch-window, resolved: plain ints as-is,
    ``auto`` as its saturated-regime bound, ``eos`` as the backstop cap,
    unparsable as 1."""
    prop = str(e.properties.get("fetch_window", 1)).strip().lower()
    if prop == "auto":
        return type(e)._AUTO_SATURATED_WINDOW
    if prop == "eos":
        return type(e)._EOS_WINDOW_CAP
    try:
        return int(prop or 1)
    except ValueError:
        return 1


def _window_entries(e) -> int:
    """Held fetch-window entries the plan must budget for (a window of
    0/1 holds nothing beyond the invoke output billed elsewhere)."""
    k = fetch_window_size(e)
    return k if k > 1 else 0


def dominant_contributor(plan: Dict[str, Any]) -> Tuple[str, str, int]:
    """(element, kind, bytes) of the single largest holding — the fix
    hint targets it."""
    best = ("pipeline", "params", plan["param_bytes_total"])
    for r in plan["rows"]:
        for kind in ("feed_bytes", "window_bytes", "loop_bytes",
                     "graph_bytes", "activation_bytes"):
            if r[kind] > best[2]:
                best = (r["element"], kind.removesuffix("_bytes"), r[kind])
    for q in plan["queues"]:
        if q["bytes"] > best[2]:
            best = (q["element"], "queue", q["bytes"])
    for s in plan.get("serving", ()):
        if s["bytes"] > best[2]:
            best = (s["element"], "serving", s["bytes"])
    return best


def fix_hint(plan: Dict[str, Any]) -> str:
    el, kind, nbytes = dominant_contributor(plan)
    mb = nbytes / 2**20
    if kind == "feed":
        return (f"lower feed-depth on {el!r} (its upload window holds "
                f"{mb:.0f} MB) or split the batch")
    if kind == "window":
        return (f"shrink fetch-window on {el!r} (its held outputs reach "
                f"{mb:.0f} MB) or flush more often")
    if kind == "loop":
        return (f"shrink loop-window (or launch-depth) on {el!r} — its "
                f"window ring + in-flight windows hold {mb:.0f} MB of "
                f"device-resident frames")
    if kind == "graph":
        return (f"shrink loop-window on {el!r} — its window's CUDA graph "
                f"holds {mb:.0f} MB of per-row activations")
    if kind == "activation":
        return (f"split batch-size on {el!r} (per-invoke activations peak "
                f"at {mb:.0f} MB) or un-fuse its pre/post stages")
    if kind == "queue":
        return (f"cap max-size-buffers on {el!r} (its HBM edge parks "
                f"{mb:.0f} MB) or move the queue past the boundary")
    if kind == "serving":
        return (f"lower serve-queue-depth (or serve-batch) on {el!r} — "
                f"its admission pool holds {mb:.0f} MB of padded "
                f"requests at capacity")
    return (f"params total {mb:.0f} MB — share backends via "
            f"shared-tensor-filter-key or quantize the checkpoint")
