"""Smoke test of the PyTorch/H100 port (yoda_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which makes the script exit non-zero when it fails:

1. Device: the card's name and power limit (nvidia-smi), then the build of
   the hand-written CUDA kernels from yoda_tpu_torch/csrc/fleet_eval.cu and
   joint_fit.cu, one nvcc each, started together (with ptxas's register
   and shared-memory report).
2. Kernels against their plain PyTorch versions on the card, tolerance 0
   (everything is int32):
   - fleet_eval: seeded fleets of 8 chips per node from 1 node to 262,144
     (smaller than one tile, ragged tiles, the main path's shapes, blocks
     walking several tiles) and K = 144 / 256 requests (launched as 128-row
     chunks), and past one 32-bit chip mask (the wide instantiation):
     8,192 x 64 chips at K = 1, 16 and 144 and 1,024 x 128 at K = 16;
     default and most-allocated weights; all six output rows must be
     equal. Per shape: the launch plan, the wrapper's time (median of
     CUDA-event timings around each call after warm-up), the plain
     version's, the bound (the bytes the function must move over the
     card's 3.35 TB/s, or its integer operations over the card's 32-bit
     rate where those take longer) and an nvidia-smi sample of SM clock
     and power. At the main path's shapes, 65,536 nodes and the wide
     shapes also the kernel's device time per call and the CUDA launches
     per call from a torch.profiler window (one per 128-row chunk per
     call: the kernel's events equal to the calls and to the wrapper's own
     launch count over the window, no other device event; a window in
     which the tracer lost kernel events is reopened, up to three, and
     printed), and at the main path's shapes the host round trip of
     TorchFleetKernel.evaluate_burst (pack, upload, launch, fetch), back
     to back and after 5 ms of sleep or of host work between calls.
   - joint_fit: seeded [K, 6, N] rows with heavy score ties, padding rows
     and gangs that fail at their first row, part-way and after a fit, at
     (K, N) = (1, 1), (3, 37), (16, 5000), (64, 8192), (256, 8192),
     (64, 65,536), (16, 262,144) (past the shared-memory ledgers: tent in
     a global scratch) and (64, 8191) (every row misaligned for the bulk
     copies); plus run (c)'s plain gangs as the scan sees them (8 gangs x
     16 identical rows, each taking a whole 8-chip host: every pick the
     next-best host) and equal top scores on both sides of every slice
     edge. Picks, group verdicts and the ledger must be equal. Per shape:
     the cluster plan (blocks, threads, ring stages, shared bytes, shared
     ledgers), the times as above, the device time and launches per call
     from the profiler, us per row, the bound, and beside them the device
     ms of the one-block design that this one replaced, as PERF.md records
     it from an earlier run (not measured here). The scan is a dependent chain of K cluster-wide arg-maxes, so
     the bytes bound is far below what any sequential design reaches.
3. The main path: the port's build_stack over its FakeCluster, a
   5,000-node fleet published by its FakeTpuAgent (512 v5p 2x2x1 slices =
   2,048 hosts x 4 chips, each a v5p-32, plus 2,952 v5e hosts x 8 chips),
   in four runs:
   (a) 64 singleton pods at batch_requests 1 and (b) 256 at
       batch_requests 16, with mixed tpu/chips, tpu/hbm, tpu/clock and
       tpu/generation labels;
   (c) gangs at batch_requests 16, created in two seeded interleaved
       waves: first 8 plain gangs of 16 v5e members x 8 chips and 4
       coscheduling-alias gangs of 4 x 4 chips with 32 singletons (their
       joint pass is plain gangs only, so its fit gate is the joint-fit
       kernel, over 144 rows), then 16 topology gangs (2x2x1, 4 v5p
       members x 4 chips: one whole v5p-32 each) and 4 multislice gangs
       (2 x 2x2x1, 8 members) with 32 more singletons (a joint pass with
       topology gangs takes the host block planner, as in the reference);
       240 gang members and 304 pods;
   (d) contention at the joint fit gate: Node objects labelled
       pool=contended on 52 v5e hosts and 4 plain gangs of 16 v5e members
       x 8 chips selecting that pool, co-queued: three fit (48 hosts), the
       fourth must park whole at the gate with nothing bound or reserved
       (it has no lower-priority victim, so preemption evicts nothing).
   Preemption is on in every run, as build_stack builds it by default.
   Each run: every pod binds (in (d) all but the parked gang) without
   over-committing a host, every gang is all-or-nothing, topology members
   land one per host on one slice and multislice members on two, every
   evaluation launched the hand kernels (fleet_eval calls ==
   dispatch_count, its launches == the 128-row chunks those calls needed,
   joint_fit launches == fused_plan_dispatches), no dispatch error, no
   Permit waiter left (no run waits on a real permit timeout), and the
   same script through kernel_platform "cpu" (the plain versions) binds
   every pod to the same node and launches nothing. Printed per run:
   pods/s, per-pod p50/p99, gang completion p50/p99 (first member's cycle
   start to the last member's bind, on the scheduler's clock), evaluation
   ms per call, and for (c)/(d) the joint_fit device ms on the inputs the
   run gave it (and us per row; per recorded launch where the tracer lost
   kernel records, with every profiler window it opened).
   Then: TorchFleetKernel.update_rows against a fresh put_static; run (e),
   256 singletons under agent churn (docstring of run_churn); run (f),
   preemption at full width (BASELINE config 5): every host has a Node
   object, 64 v5e hosts are pool=mixed-e and 4 v5p-32 slices pool=mixed-p;
   wave 1 (priority 1) fills both with 256 pods of 2 chips and 16 of 4,
   the agent republishes the bound hosts, and wave 2 (batch_requests 16)
   brings 2 plain gangs of 16 x 8 chips (priority 100) and 8 singletons of
   8 chips (priority 50) on mixed-e and 2 topology gangs 2x2x1 (priority
   100) on mixed-p. Its bindings, evicted pods, evictions, nominations,
   re-stacks and delta syncs must equal the CPU run's, every wave-2 pod
   binds (gangs whole, topology gangs on one slice), no host is over its
   healthy chips, and it prints wave 2's pods/s, p50/p99, gang p50/p99
   and PostFilter ms per call. Then run (g), inter-pod affinity, topology
   spread, volumes and budgets on the same fleet: every host has a Node
   object with its hostname and one of four zones (each v5p slice wholly in
   one, the v5e hosts in four blocks of 738), and wave 1 (batch_requests
   16) brings, in this order, 24 volume pods (16 claims labelled for a
   zone and bound to CSI PVs whose nodeAffinity names it, two zone-2 hosts
   with local SSD and an attach limit of 1 that zone 2's volume pods
   prefer; 4 WaitForFirstConsumer claims with their selected node; 4 pods
   sharing a ReadWriteOnce claim that a Running pod mounts), 64 plain
   singletons in run (b)'s mix, 48 llm-serve replicas (v5e, 4 chips,
   required anti-affinity over hostname, a DoNotSchedule zone spread with
   maxSkew 1 and matchLabelKeys pod-template-hash), 48 kv-cache pods with
   preferred affinity (weight 100) to them, 4 team-b pods with required
   zone affinity to them through a namespaceSelector, and gangs ft-a (8 x
   4 chips, self anti-affinity over hostname) and ft-b (8 x 8 chips, self
   affinity over zone). Wave 2: 32 tainted v5e hosts of pool mixed-g
   filled at priority 1, half of the pods under a budget that allows no
   disruption, the agent republishing every bound host, a priority-100
   gang of 16 x 8 chips on the pool (it may evict only the unprotected
   half) and a priority-50 singleton of 8 chips (its eviction is refused).
   Its bindings, evictions, refused evictions, nominations and counters
   must equal the CPU run's, and every placement must hold (replicas on
   distinct hosts with zone skew <= 1, ft-a on 8 hosts, ft-b in one zone,
   volume pods where their claims allow, no attach limit exceeded, no
   protected pod evicted). Printed: both waves' pods/s and p50/p99, gang
   p50/p99, host ms per call of the evaluator builds, of the admission row
   with an AffinityData and of the preference bonus, PostFilter ms,
   fleet_eval's device ms at K = 1 on an input of the run, and the parts
   build_stack did not build (Stack.not_built). Then a fleet of 40-chip
   and 8-chip hosts (the wide kernel on the main path) at K = 1 and 16
   must bind as on the CPU. Last, run (h), the background path on the
   5,000-node fleet (``run_background``, ``BACKGROUND_FULL``; the tests
   run ``BACKGROUND_SMALL``):
   (h1) 128 v5e singletons of 1, 2, 4 and 8 chips at K = 1 in 8 waves of
       16 (cut from 16 waves to hold the script's time), one ``speculate_once`` before each: the speculative cache's
       private TorchFleetKernel evaluates on its own CUDA stream and the
       serve path binds hot shapes from its plans. Printed: hits, misses,
       invalidations, ms per speculate_once, ms per consumed plan's bind,
       pods/s and p50/p99, the private kernel's launches, and fleet_eval
       at K = 1 on the private stream alone and while a second thread
       launches what the serve path launches on the default stream
       (fleet_eval at K = 16, joint_fit on 64 x 8,192 rows): device ms
       and overlap in time from a profiler window of each, both threads'
       results held against the plain version;
   (h2) 64 v5e hosts filled at priority 1, 1x1x1 topology gangs on 4 v5p
       slices with each slice's diagonal deleted, an elastic gang (min 4,
       max 16, size 8) and a parked priority-100 gang of 16 x 8 chips in
       a stack with preemption off, on a held scheduling clock:
       ``resync`` and ``run_once`` until a pass changes nothing
       (preemption, resize and repack moves); the gang's completion is
       the wall time from the start of the pass that admits it to the end
       of the drain after it;
   (h3) a stack rebuilt over (h2)'s cluster with a half-bound gang left
       by the dead leader (adopted, completes), then a ghost binding, a
       dropped deletion and a leaked claim for the drift pass;
   (h4) ``run_forever`` on a second thread (1 s passes, 50 ms speculation
       ticks) while the main thread serves 256 singletons and four plain
       gangs (two joint passes of two gangs) at K = 16 over about 8 s,
       with at least one rebalance pass begun inside that window:
       invariants only (capacity, accounting, whole gangs, every consumed
       plan's node admits its pod, both threads launched fleet_eval and
       the serve thread joint_fit, counted per kernel object from zero
       just before the window, no error logged).
   (h1)-(h3) must equal the same script on kernel_platform "cpu" in
   bindings, plans, counters and reports; that CPU run goes on in a
   second process (two threads), started once the kernels are built, so
   it overlaps the card's phases. (h4) runs on the card only, twice: as
   above and with the speculative cache off (``spec_enabled=False``),
   each printing the burst rows that failed the serve-time check and
   the serve path's dispatches and launches per pod.
   Then run (i), the node health path on the same fleet
   (``run_nodehealth``, ``NODEHEALTH_FULL``; the tests run
   ``NODEHEALTH_SMALL``), every host with a Node object: an elastic gang
   (16 x 8 chips, min 8) on a 16-host pool, two plain gangs of 16 x 8 on
   a 32-host pool, then 16 topology gangs (2x1x1 x 4 chips, each on a
   v5p slice of its own), 6 more plain gangs of 16 x 8 and 128
   singletons, at K = 16 with ``bind_workers`` 0 (unbinds in order). One
   fake wall clock drives the agent's stamps and the monitor's ladder,
   and a stepped scheduling clock the queue, so both platforms take the
   same decisions; the monitor is driven by ``run_once``:
   (i1) 64 heartbeats holding gang members and singletons stop and the
       clock passes ``node_suspect_after_s``: 64 rows fenced (a probe
       dispatch right after counts the admission rows patched, with no
       re-stack and no row update); 256 singletons served at K = 16,
       none on a fenced host; 32 heartbeats resume (a flap: no repair);
       the other 32 pass ``node_down_after_s``, and one pass patches the
       topology and plain gangs, shrinks the elastic gang and requeues the
       singletons;
   (i2) ``kill_node`` under a topology gang (its claims released at event
       time) and ``set_node_ready(False)`` under a plain gang, repaired;
   (i3) a drain under a topology gang that the rebalancer's pass migrates,
       and a drain with deadline 0 that the next pass evacuates;
   (i4) 18 hosts under the two pool gangs go silent past the down
       threshold: both requeue whole and park; the heartbeats resume, the
       fence opens, and both gangs bind in one fused joint pass (the
       ``joint_fit`` launch).
   Bindings after each part, node states, fence sets and every pass's
   RepairReport must equal the CPU run (in the rerun process above); no
   pod may bind on a host while fenced, no host over its chips, no gang
   split, no claim leaked, and on the card every ``fleet_eval`` and
   ``joint_fit`` call of the run equals its plain version on the same
   inputs. Printed: ms per pass, each repair's ``durations_ms``, host ms
   from a pass to each repaired gang's last re-bind, the counters across
   each fence flip and the launches by part.
   Then run (j), observability at its defaults on the same fleet
   (``run_observability``, ``OBSERVABILITY_FULL``; the tests run
   ``OBSERVABILITY_SMALL``):
   (j1) run (b)'s 256 singletons at K = 16, then run (c)'s two gang
       waves, on a stepped scheduling clock, with a ``ConfigReloader``
       reload between the waves (``trace_sample_rate``,
       ``spec_cache_size``, ``rebalance_max_moves``,
       ``overload_queue_high`` and the immutable ``scheduler_name``).
       Bindings, every ``/metrics`` sample (less the values of the
       wall-clock families), the phase histogram's counts, the
       why-pending summary and each pending key's explanation, the SLO
       evaluation, the multiset of (subject, span, parent span), the
       number of trace entries and the reload's report and live values
       must equal the CPU run's (a second spawned process, ``SpawnedRerun``).
       Then the same
       script on the wall clock, card only: each phase's p50/p99, the
       Perfetto trace under ``build/`` and its spans per track, every
       gang-dispatch / joint-dispatch span held against the CUDA-event
       time of the launches inside it, every endpoint fetched from a
       thread during the run and again after it ((j4)), the median ms of a
       ``/metrics`` scrape, of the bin-packing gauge and of one SLO
       evaluation at 5,000 nodes;
   (j2) the ladder on a stepped clock (``overload_queue_high`` 64, the
       cycle signal off): 320 spot singletons and a spot gang with one
       member at Permit climb it to SHED in three evaluations; SHED parks
       the spot pods (``overload-shed``) and admits the gang's second
       member and 8 prod pods; stepping down, BROWNOUT admits 10 and
       quota-parks the rest, and everything binds. Levels, gates, the
       tracer's rate, parks and bindings at every step equal the CPU run;
   (j3) card only, reported: the ladder's ``run_forever`` at the default
       1 s period and 250 ms threshold on its own thread beside a K = 1
       serve of run (a)'s pods, then 3 s more: the ``total`` p50/p99,
       every evaluation's signals, each transition and the seconds at
       each level;
   and tracing's cost, card only, reported: run (b) in one pair (cut from
   five, then two), ``trace_sample_rate`` 1.0 then 0, with each side's
   pods/s and p99. Every ``fleet_eval`` and
   ``joint_fit`` call of run (j) is held against its plain version, and
   the launches held must equal the module's counts, part by part.
   Then run (k), the stack the shipped ConfigMap describes
   (deploy/yoda-tpu-scheduler.yaml, read by ``configmap_config``: 2 ms
   ingest window, batch max 256, tenant fairness, K = 1), with only the
   platform (and in (k2) the quota) overridden, on the same fleet
   (``run_tenancy``, ``TENANCY_FULL``; the tests run ``TENANCY_SMALL``):
   256 one-chip singletons of a flooding tenant, then three light
   tenants' pods, each 16 singletons of 1-4 chips and 2 plain gangs of
   8 x 4 chips, in a seeded order (the traffic's depth is cut: see
   ``TENANCY_FULL``):
   (k1) on a stepped clock: each step the agent republishes 256 hosts in
       turn, 4 bound flood pods are deleted, and up to 16 loop turns run
       with the batcher flushed before each, so the batches at every
       dispatch are the same on both platforms. Bindings, pop order,
       Events (reason, pod, count), ``/metrics`` samples (less the
       wall-clock values and the batch-size histogram, which follows the
       drain thread), per-step shares, quota parks and why-pending
       counts, ``rows_applied`` / ``delta_syncs`` and each tenant's bind
       latency on the stepped clock must equal the CPU run; then the same
       script with ``tenant_fairness: false`` (card only, reported: the
       light tenants must wait longer);
   (k2) (k1)'s script with ``tenant_quota_chips`` 128 for 32 steps: the
       flood parks at its quota (its bound chips never past 128, the
       why-pending verdict names the quota), each step's deletions retire
       parks, every light tenant binds; equal to the CPU run;
   (k3) on the wall clock with the batcher's own 2 ms drain thread: a
       publisher thread republishes every host once per 10 s (the
       agent's interval: 500 CRs/s) and, 2 s in, all 5,000 hosts within
       1 s (an agent rollout), ticking the overload ladder each second,
       while the main thread serves the pods with ``run_until_idle``.
       Reported: pods/s, each tenant's p50/p99, ingest batch sizes, raw
       and coalesced events, the largest backlog, ``update_rows`` calls
       and rows per call, the ladder's levels and ingest signal, Events
       written and dropped. Checked on both platforms, order-free (the
       ladder reads the wall clock, so what it parks differs): every pod
       bound or pending for a recorded reason, no host over its healthy
       chips, gangs whole, one ``Scheduled`` Event per bound pod.
   Every ``fleet_eval`` / ``joint_fit`` call and every ``update_rows``
   launch of run (k) is held against its plain version
   (``KeptKernels``, ``KeptRowUpdates``: the whole resident state after
   the update against ``stack_static`` of the refilled fleet). The CPU
   run of (k1)-(k3) goes on in a third spawned process
   (``SpawnedRerun``).
   Then run (l), the scheduler process (``yoda_tpu_torch.cli``) through
   its entry point, on the card (``run_wire``, ``run_failover``,
   ``run_pipeline``, ``run_demo_pair``; ``PROCESS_FULL`` /
   ``PIPELINE_FULL``, the tests run the small sizes on the CPU):
   (l1) the port's ``FakeKubeApiServer`` holding the 5,000-node fleet as
       TpuNodeMetrics CRs and Node objects; ``cli.main(["--leader-elect",
       ...], stop=)`` on a thread with ``YODA_KUBE_API_URL`` set (its
       stack recorded and instrumented through the ``standalone`` module
       attribute, ``Replicas``); 4 plain gangs of 16 x 8 v5e created
       before it starts (its first pop is a joint pass of them alone),
       then, once ``/readyz`` answers 200, 128 singletons (run (b)'s mix;
       cut from 256),
       4 coscheduling gangs of 4 x 4 and 8 topology gangs (2x2x1, 4 x 4
       v5p) over HTTP (run (c)'s mix at a quarter of its gangs), while a
       thread republishes every CR each 10 s (the agents). Gates: the bind pipeline on through ``auto`` with 8 workers,
       every pod bound or pending with a why-pending verdict, no host over
       its healthy chips, gangs whole (topology gangs on one slice), one
       binding POST per pod and no 409 (the server's binding log),
       ``yoda_overlap_cycles_total`` > 0 on ``/metrics``, the resync once
       before the first pop, every launch equal to its plain version.
       Reported: the nvcc build, informer sync, lease acquire to first
       bind, first cycle, pods/s, per-pod p50/p99 (API creation to
       binding), gang completion p50/p99, ``yoda_bind_wall_ms`` p50/p99,
       the largest in-flight bind count, the launches;
   (l2) two replicas in one process (own stop and lease identity each):
       the leader binds 64 singletons, is stopped, 64 more are created
       (cut from 128 and 128);
       the standby (``/readyz`` not 200 until then) takes the lease, runs
       its resync once before its first pop and binds the rest, no pod
       bound twice. Reported: the leader's stop to the standby's first
       bind;
   (l3) ``build_stack`` over ``FakeCluster(bind_latency_s=0.002)`` at the
       default 8 workers (pipelined by ``auto``): gang waves and
       singletons, and one plain gang alone whose first member's bind
       fails once after every sibling has landed (``FailingCluster``):
       bindings (gangs as host lists), the pods the rollback unbound and
       the Events must equal the CPU run (a fourth spawned process);
   (l4) ``cli.main(["--demo"])`` on the card prints the placements of
       ``--demo --device cpu``.
   Every ``fleet_eval`` / ``joint_fit`` / ``update_rows`` launch of run
   (l) is held against its plain version.
   Then run (m), loop mode (``mode: loop``: the per-node plugins on the
   host; ``run_loop``, ``LOOP_FULL``; the tests run ``LOOP_SMALL``) on the
   5,000-node fleet:
   (m1) run (a)'s first 32 singletons (cut from 64), each created in a
       loop-mode stack and in
       a default stack on the card over the same fleet and scheduled there
       at K = 1 (one pop, one cycle): every outcome and node must agree, as
       tests/test_ops.py's ``test_batch_and_loop_agree`` asserts on the CPU,
       and the card's launches equal the default stack's dispatches;
   (m2) a loop-mode stack at ``percentage_nodes_to_score`` 25 on a held
       scheduling clock drains 4 plain gangs of 4 x 8 v5e chips, a topology
       gang (2x2x1, 4 x 4 v5p chips) and 16 singletons: every pod bound,
       gangs whole, the topology gang on one slice, no host over its
       chips, nothing launched, bindings equal to the same script on
       ``kernel_platform: cpu``. Loop mode filters and scores in host
       Python, so the depth is cut (run (c)'s plain gangs have 16 members).
   Printed: host ms per pod of both stacks, per filter call and per score
   call.
   Then run (n), the node-sharded evaluation (``parallel/sharded.py``,
   the shard entry of fleet_eval.cu):
   (n1) ``ShardedDeviceFleetKernel`` over 1 and 4 shards of the card at
       8,192 x 8 (K = 1, 16) and 8,192 x 64 (K = 16), default and
       most-allocated weights: every result equal to the unsharded
       ``fleet_eval`` and to the plain shard version (on host shards, and
       on the card's tensors), three launches per shard per 128 requests.
       Per shape: ms per call (the phases and the combines, CUDA events),
       the plain version's, the unsharded kernel's on the same inputs, the
       device ms of each phase and of the combines (profiler) and the
       bound;
   (n2) a ``mesh_devices: 1`` stack binds run (b)'s 256 pods at K = 16 as
       the default stack did in the main path, every sharded evaluation
       held against the unsharded plain version on the same inputs, the
       shard entry launched and ``fleet_eval`` not, every count zeroed
       just before the drive;
   (n3) ``mesh_devices`` past the card count raises at construction.
   Then run (o), the scheduler lanes, the durable journal and profiles
   (``run_lanes``, ``LANES_FULL``; the tests run ``LANES_SMALL``) on the
   5,000-node fleet with ``shard_count`` 4 (the shipped manifest's
   recommendation): run (c)'s two gang waves, run (b)'s 256 singletons
   split over them, and in the first wave a plain gang of 8-chip v5e
   members one larger than any lane's v5e hosts (the router sends it to
   the global lane); every pod's uid is its name. Every ``fleet_eval`` /
   ``joint_fit`` launch of run (o) is held against its plain version.
   (o1) ``build_sharded_stacks`` with the journal (``journal_sync:
       batch``) on a held clock, lane after lane in a fixed order, binds
       the first wave, and (o3) carries on to the second: each pod's lane
       and node, the commits, conflicts and rollbacks and the journal
       files byte for byte must equal the CPU run (a fifth spawned
       process);
   (o2) every lane's ``serve_forever`` on a thread of its own, wired as
       the CLI wires them (the global lane resyncs first, its rebalancer
       thread ticks its speculation, the rescue pass runs), on the wall
       clock over the same pods, wave after wave (the first wave only at
       the full size), at a 15 s Permit timeout
       (``O2_PERMIT_TIMEOUT_S``), under a profiler window
       (CUDA activity): every pod bound (a wave is done once every pod is
       bound and no claim is left staged), gangs whole, no host over its
       chips, no pod bound twice, the accountant's claims exactly the
       bound pods. Reported (at the tests' small size beside a one-stack
       run of the same script and the same run with the journal off, both
       cut at the full size): pods/s, p50 / p99, each lane's
       launches and first re-stack ms, the kernel records that overlap one
       on another stream, commits and conflicts;
   (o3) after (o1)'s first wave, with the lanes' commits cut off, a
       topology gang binds (its claims left staged) and two members of
       another park at Permit; the set is dropped without ``close``; a
       new set over the same cluster and journal replays (``replayed``),
       resyncs warm before any bind, commits the bound residue in a drift
       pass and binds the second wave, no pod bound twice, equal to the
       CPU run. Reported: replay ms, records, bytes, fsyncs;
   (o4) ``build_profile_stacks`` with the base profile and
       ``yoda-tpu-pack`` (most-allocated) over one accountant and one
       cycle lock: run (b)'s singletons alternating between them and run
       (c)'s topology gangs, drained profile after profile on a held
       clock, equal to the CPU run with each profile's launches counted.
   Then run (p), the lanes as worker processes and the commit transport
   (``run_proc``; ``PROC_FULL`` / ``PROC_WIRE_FULL``, the tests run the
   small sizes on the CPU), on the same fleet; the card's compute mode and
   whether MPS runs are printed first:
   (p1) this process is the parent (``build_proc_parent``, the journal at
       ``journal_sync: batch``, a ``CommitRPCServer`` on a Unix socket and
       a ``WorkerSupervisor``) of 4 spec worker processes, each spawned
       through this script's own ``--spec-worker`` entry, which runs the
       port's ``procserve._run_spec_worker`` on the card with every
       ``fleet_eval`` / ``joint_fit`` launch kept and, at exit, writes its
       launches, their largest difference from the plain versions and ms
       per evaluation to a file. Each worker gets the hosts of its
       ``ShardMap(4)`` partition (generation and chips only: the v5p
       hosts come without slices) and the pods the parent's router sends
       its lane (run (b)'s 256 singletons and run (c)'s 8 plain gangs of
       16 x 8 chips), drains 8 warm-up singletons, waits at the start
       barrier and drains the timed pods. Gates: every pod bound and
       committed, gangs whole, no host over its chips, 0 staged residue,
       0 leaked chips and 0 commit conflicts at the parent, every worker
       launched ``fleet_eval`` and every launch equals its plain version;
       each lane's journal records, the bindings, the parent's claims and
       the reports equal the same run with ``--device cpu`` workers (in a
       spawned process, after the card's). Reported: pods/s (timed pods
       over the slowest worker's wall) against run (o2)'s thread lanes
       (and, at the tests' small size, the same script in one worker
       process and as thread lanes; cut at the full size), each worker's
       pods/s, admission p99 and ms per evaluation, the commit RPC's p50 /
       p99 by op, ``os.cpu_count()``;
   (p2) ``python -m yoda_tpu_torch.cli`` with ``shard_count`` 4,
       ``shard_mode: process`` and the journal over run (l)'s API server
       process: run (c)'s two gang waves with 64 of run (b)'s singletons
       (cut from 256, then 128) split over them; the worker of lane s0 gets SIGKILL
       once half of wave 1 is bound and every worker has run a cycle. Gates: every pod bound, gangs whole on valid blocks, no
       host over its chips, no second bind refused (409), ``/debug/shards``
       showing 4 workers alive and lane s0 restarted once, no staged
       residue after the drift pass, every worker's pid among nvidia-smi's
       compute apps before the kill and after the respawn,
       ``yoda_commit_rpc_calls_total`` above 0. Reported: pods/s, p50 /
       p99, the kill to the respawned lane's first bind;
   (p3) a ``--leader-elect`` leader CLI with 2 process lanes and
       ``commit_listen`` on a loopback port, and a standby CLI with
       ``commit_endpoint`` pointing at it, in one process; the leader
       binds 32 of 64 singletons (cut from 64 of 128), the standby's
       ``yoda_standby_lag_frames`` reads 0, the leader is stopped: the
       standby promotes its tailed mirror warm (the leader's claims) at
       the old term + 1, the term bump first among its new frames, and
       binds the rest, no pod bound twice. Reported: the lag, the stop to
       the standby's first bind.
   Then run (q), the port's trace replayer and chaos harness
   (``run_chaos``, ``CHAOS_FULL``; the tests run ``CHAOS_SMALL`` on both
   packages), each part against its CPU run (a spawned process beside the
   card's), every ``fleet_eval`` / ``joint_fit`` / ``update_rows`` launch
   held against its plain version and every stack on the card:
   (q1) ``testing.tracegen.replay`` over the 5,000-node fleet with the
       rebalancer driven (its default configuration, ``kernel_platform:
       auto``, with ``bind_workers: 0``): two virtual minutes of three
       tenants on a diurnal wave (team-a singletons at priority 5, team-b
       singletons and plain gangs of 2-4, team-c 2x2x1 topology gangs), a
       flash crowd, foreign churn, 4 hosts killed at 60 s, 8 drained at
       80 s for 30 s. The fingerprint, the SLO evaluation, the counts and
       every pod's nodes must equal the CPU run. Reported: the counts, the
       SLO verdict, pods/s over the replay's wall time;
   (q2) ``tests/test_chaos.py``'s shard crash mid-commit through
       ``testing.chaos.build_cross_shard_contention`` (4 lanes, 4
       contended slices, 2,952 v5e hosts): a plain gang of 4 x 4 chips,
       the process crashed at its second bind, a respawned assembly over
       the same backing cluster resyncs (rolling the half gang back) and
       binds it whole; lane after lane on a held clock; the test's
       invariants, bindings equal to the CPU run;
   (q3) ``tests/test_overload.py``'s overload storm (seed 1337, 8 rounds,
       then calm) through ``testing.chaos.build_overload_storm`` at its
       own 4-host fleet: SHED reached, every pod bound in the end, the
       ladder's level after each round, the shed count and every pod's
       first node equal to the CPU run.
   Then run (r), federation and the node agent (``run_federation``,
   ``FEDERATION_FULL``; the tests run ``FEDERATION_SMALL``, (r1) and (r3)
   on both packages), each part against its CPU run (a spawned process
   started beside run (q)'s), every ``fleet_eval`` / ``joint_fit`` /
   ``update_rows`` launch held against its plain version and every stack
   on the card:
   (r1) ``standalone.build_federation`` over two ``testing.chaos``
       ``ChaosCluster`` fronts, each a ``FakeCluster`` holding the
       5,000-node layout (the secondary's from another seed), every host
       with a Node object, 32 (home) and 48 (secondary) seeded v5e hosts
       kept for the federated gangs (pool=train, a NoSchedule taint those
       gangs tolerate), a one-chip occupant on the first host of every
       home v5p slice and of all but 12 seeded secondary slices (bound
       before the run, adopted by the first resync), on a held clock with
       5 / 10 / 30 s health thresholds: a health pass; run (c)'s first
       wave at home and 16 singletons at the secondary; 8 plain gangs of
       16 v5e x 8 chips for the train hosts, then 8 2x2x1 topology gangs,
       at home (home fits 2 plain gangs); a spillover pass in which the
       secondary is partitioned at the first create of the third gang it
       migrates (that gang rolls back whole, two stay migrated, the rest
       cannot be created); health passes 4 s of the clock apart walk the
       secondary UP -> DEGRADED -> PARTITIONED -> LOST while home binds
       run (b)'s 256 singletons and, behind the partition, 4 of the
       secondary's bound pods are deleted and 8 pods created; the heal,
       a health pass (the rejoin resync releases the dropped deletions'
       claims), the secondary's drain, a second spillover pass (the
       rolled-back gang and the topology gangs migrate; the shared ledger
       keeps the other plain gangs home, each of which fits the secondary
       alone) and the drains. Gates: no bind by a fenced member, no pod
       bound in two clusters, no host over its chips, every gang whole in
       exactly one cluster, the secondary's first bind after the heal
       after its resync. Equal to the CPU run: each cluster's bindings,
       the states after every health pass, the passes' migrations, the
       federation's series, the gangs the ledger kept, the resync's
       report. Reported: ms per ``spillover_pass`` and ``health_pass``,
       each migrated gang's completion, each member's launches;
   (r2) ``python -m yoda_tpu_torch.cli --federate-url remote=URL`` on a
       thread at default settings with small health thresholds in its
       config, home run (l)'s API server process at 5,000 nodes, the
       remote a second server process (40 hosts) stopped before the CLI
       dials it: startup gives the remote's sync up at 5 s, ``/readyz``
       turns 200, home binds 64 singletons, ``/metrics`` shows the remote
       at LOST (3), nothing is written to it; then a ``--agent
       --node-name agent-0`` process (``YODA_TPUINFO_SPEC`` a v6e host of
       8 chips) publishes its CR to home and a v6e pod binds there;
   (r3) a default stack at K = 16 over the 512 v5p slices and 2,952 v5e
       hosts, each v5e host published by a ``NativeTpuAgent`` through the
       native library (built from ``native/tpuinfo.cc``) under
       ``YODA_TPUINFO_SPEC``: run (b)'s 256 singletons bind; every
       agent's next ``run_once`` charges its bound pods' HBM (the row
       updates); 256 more bind. CRs (timestamps masked) and bindings equal
       to the CPU run.
   Last, run (s), the degraded-mode dispatch chain on the 5,000-node
   fleet at default settings (``FALLBACK_FULL``; the tests run
   ``FALLBACK_SMALL``), faults injected through the port's
   ``testing.chaos`` (``install_chaos_kernel``; the fused plan through the
   script's ``install_plan_fault``). The port demotes only a primary on
   the host, so the chain runs on ``kernel_platform: cpu`` stacks
   (``run_fallback``), every demoted call kept, and the card's stacks are
   shown not to demote (``run_card_faults``):
   (s1) one-shot faults, each installed alone and removed after: 16 run
       (a) singletons at ``batch_requests`` 1, a K = 16 burst of run (b)'s
       pods and a joint pass of two plain gangs of 16 x 8 v5e chips (the
       fused plan; one gang alone takes the split pass) at
       ``batch_requests`` 16, each after 8 warm-up singletons: each fault
       served at level 1 (the plain version on a host copy) in its cycle,
       the pin back at 0 and the primary serving the next dispatch;
   (s2) a persistent fault (``count`` 100): three singletons pin level 1,
       the plan's invocations stop, ``/metrics`` renders
       ``yoda_dispatch_backend_level 1`` and the fallbacks, 64 singletons
       bind at level 1; level 1 wrapped in a ``ChaosKernel`` too, 16
       singletons pin level 2 (the numpy evaluator) and two plain gangs
       bind there;
   (s3) each demoted call again on the card's hand kernels on its own
       inputs and rows: all six result rows, picks and fits equal
       (tolerance 0); ms per call of levels 0, 1 and 2 on a K = 1 and a
       K = 16 input of the run;
   (s4) (s1)'s one-shot faults and a persistent fault over three
       singletons on card stacks: every fault counted in
       ``dispatch_errors`` and re-raised, nothing demoted, no pin, no host
       level built, ``/metrics`` at level 0 with no fallback; the K = 1
       pod's cycle ends in error, a failed burst or joint pre-evaluation
       leaves its pods to their own dispatches on the card; every pod
       binds on the card after its retry, and two more plain gangs take
       the fused plan on the card.
   Every other phase must leave every batch plugin's
   ``dispatch_errors``, ``dispatch_fallbacks`` and ``backend_level`` at 0
   (``DispatchWatch`` over every dispatch of this process, and each run's
   own records; (p1)'s workers and (r1)'s member stacks report theirs).
   Run (s) comes last, and lifts the bound its level-1 kernels put on
   torch's intra-op pool when it ends.
4. One line {"kernels": [...]} with each kernel's launches over every run
   above (runs (h)'s, (i)'s, (j)'s, (k)'s, (l)'s, (o)'s, (q)'s, (r)'s and
   (s)'s also by part or apart, run (r)'s by member stack, run (o)'s by
   lane, run (p1)'s by worker process, and the
   speculation thread's apart; the shard entry's from run (n2)), its
   largest difference from the plain version and its times ("not
   measured" where the profiler saw no device activity); ``fleet_eval``'s
   also run (s)'s demoted calls, their largest difference from the hand
   kernels and ms per dispatch by level.
   Before it, one line of each phase's wall seconds.

The last line is {"ok": true, "device": {...}}. Without a CUDA device the
script exits non-zero and prints no result. The script re-executes itself
once with ``PYTHONHASHSEED=0`` (the spawned CPU reruns inherit it): run
(o)'s journal bytes follow the order of sets of pod keys.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import statistics
import subprocess
import sys
import threading
import time

import numpy as np
import torch

MEM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3 (NVIDIA data sheet)
INT32_OPS_PER_S = 67e12       # H100 SXM non-tensor-core 32-bit rate
OPS_PER_CHIP_ELEMENT = 60     # integer ops per (chip, request) pair, both passes

KERNEL_SHAPES = [  # (real nodes, padded nodes, requests K)
    (1, 1, 1),              # smaller than one 64-node tile
    (37, 37, 1),
    (37, 64, 1),
    (37, 37, 16),
    (256, 256, 8),
    (5000, 5000, 16),       # not a multiple of the tile
    (5000, 8192, 1),
    (5000, 8192, 16),
    (65536, 65536, 16),
    (262144, 262144, 4),    # more tiles than the grid: blocks walk several
]
# fleet_eval past one launch's 128 requests: chunked, still exact.
CHUNKED_SHAPES = [(5000, 8192, 144), (5000, 8192, 256)]
# Past 32 chips a node (one 33-chip host pads every node to 64): the wide
# instantiation, (real nodes, padded nodes, K, chips). 8,192 x 64 stages its
# tiles at K = 1 and 16 and reads global memory at K = 144 (two 128-row
# chunks); 1,024 x 128 reads global memory.
WIDE_SHAPES = [
    (5000, 8192, 1, 64), (5000, 8192, 16, 64), (5000, 8192, 144, 64),
    (1000, 1024, 16, 128),
]
MAIN_PATH_SHAPE = (5000, 8192, 16)
JOINT_SHAPES = [
    (1, 1), (3, 37), (16, 5000), (64, 8192), (256, 8192), (64, 65536),
    (16, 262144),  # past the shared-memory ledgers
    (64, 8191),    # rows misaligned for the bulk copies
]
JOINT_MAIN_SHAPE = (64, 8192)  # run (d)'s joint pass
# The one-block design that joint_fit.cu's cluster design replaced: its
# device ms per call as PERF.md records them from the run that measured it
# (H100 80GB HBM3 at 700 W). Not measured here: printed beside this run's
# times on the per-shape lines only, never in the kernels line.
ONE_BLOCK_DEVICE_MS = {
    (1, 1): 0.0022, (3, 37): 0.0041, (16, 5000): 0.0416, (64, 8192): 0.2207,
    (256, 8192): 0.8783, (64, 65536): 2.3456, "run c": 0.403, "run d": 0.047,
}
# Shapes whose device time the profiler reads: the main path's two and a
# fleet of 65,536 nodes.
PROFILED_SHAPES = [(5000, 8192, 1), (5000, 8192, 16), (65536, 65536, 16)]
CHIPS = 8
REQUEST_TABLE = np.array(
    [[1, 0, 0, 0, 0], [2, 8192, 0, 0, 0], [4, 4096, 900, 5, 1], [8, 15360, 990, 6, 0]],
    dtype=np.int32,
)


def not_measured(value):
    return "not measured" if value is None else value


def fail(phase: str, err: BaseException | str) -> None:
    print(f"FAILED in {phase}: {err}", file=sys.stderr)
    sys.exit(1)


def random_fleet(n_real: int, n_pad: int, seed: int, chips: int = CHIPS):
    """Seeded stacked fleet in the device layout: chips [9, C, N], static
    nodes [4, N], dynamics [4, N] (rows >= n_real are padding)."""
    rng = np.random.default_rng(seed)
    valid = np.zeros(n_pad, dtype=np.int32)
    valid[:n_real] = 1
    grid = (chips, n_pad)
    total = np.full(grid, 16 * 1024, dtype=np.int32)
    free = (total - rng.integers(0, 16 * 1024, size=grid)).astype(np.int32)
    chip_rows = np.stack(
        [
            np.broadcast_to(valid, grid),
            valid * (rng.random(grid) > 0.1),
            free < total,
            free,
            total,
            rng.integers(700, 1000, size=grid),
            rng.integers(400, 900, size=grid),
            rng.integers(100, 300, size=grid),
            rng.integers(100, 200, size=grid),
        ]
    ).astype(np.int32) * valid
    nodes = np.stack(
        [
            valid,
            rng.random(n_pad) > 0.5,
            rng.integers(2, 7, size=n_pad),
            rng.integers(0, 3, size=n_pad),
        ]
    ).astype(np.int32)
    dyn = np.stack(
        [
            valid * (rng.random(n_pad) > 0.05),
            rng.integers(0, 4, size=n_pad),
            rng.integers(0, 64 * 1024, size=n_pad),
            np.zeros(n_pad),
        ]
    ).astype(np.int32)
    return chip_rows, nodes, dyn


def bound(n: int, k: int, c: int = CHIPS) -> tuple[float, str]:
    """Least time for the evaluation in ms, and what sets it: each input
    read once and each output written once over the memory rate, against
    the integer operations per (chip, request) pair over the card's 32-bit
    rate (bytes at 8 chips; operations at 64 chips and K = 144)."""
    in_bytes = (9 * c * n + 4 * n + 4 * n + k * n + 5 * k) * 4
    out_bytes = 6 * k * n * 4
    bytes_s = (in_bytes + out_bytes) / MEM_BYTES_PER_S
    ops_s = OPS_PER_CHIP_ELEMENT * c * n * k / INT32_OPS_PER_S
    return max(bytes_s, ops_s) * 1e3, "bytes" if bytes_s >= ops_s else "operations"


def cuda_ms(fn, warmup: int = 3, iters: int = 20) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def profiled_ms(
    fn, counter, calls: int = 20, kernel: str = "fleet_eval", windows: int = 3,
    short_ok: bool = False, per_call: int = 1,
) -> tuple[float | None, float | None, list[dict]]:
    """Device time of ``kernel`` per call (summed over the call's
    ``per_call`` launches: 128-row chunks) and its CUDA launches per call,
    from a torch.profiler window over ``calls`` calls of ``fn``, and what
    each window opened saw; (None, None, windows) when the profiler records
    no device activity. ``counter()`` reads the wrapper's own launch count.

    Each window is held against two counts besides its kernel events: the
    wrapper's own launches over it, which must equal ``calls`` x
    ``per_call``, and the launch calls (cudaLaunch*) that the tracer
    recorded on the host. It raises on any device event but ``kernel``'s (a
    memset, another kernel) and on more kernel events or launch calls than
    that. The first window with exactly that many kernel events gives the
    times; a short
    one is reopened, up to ``windows`` windows, and when none is exact it
    raises. With ``short_ok``, for inputs on which the tracer was seen to
    lose kernel records (on an H100 80GB HBM3, 1 or all 20 of them on the
    gang runs' inputs, while both counts said 20), the fullest short window
    whose host launch calls equal ``calls`` gives the device time per
    recorded launch instead, and the launches per call are those launch
    calls per call. Each window opens 50 ms before its first call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    seen, fullest = [], None
    expected = calls * per_call
    for _ in range(windows):
        before = counter()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            time.sleep(0.05)
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        kernel_us, events, launch_calls, others = 0.0, 0, 0, {}
        for evt in prof.key_averages():
            if evt.device_type != DeviceType.CUDA:
                if evt.key.startswith("cudaLaunch"):
                    launch_calls += evt.count
                continue
            if evt.key.startswith("Memcpy"):
                continue
            if kernel not in evt.key:
                others[evt.key] = evt.count
                continue
            events += evt.count
            total = getattr(evt, "self_device_time_total", None)
            if total is None:
                total = evt.self_cuda_time_total
            kernel_us += total
        window = dict(kernel_events=events, wrapper_launches=counter() - before,
                      host_launch_calls=launch_calls)
        seen.append(window)
        if (others or max(events, launch_calls) > expected
                or window["wrapper_launches"] != expected):
            raise AssertionError(
                f"{kernel}: not {per_call} launch(es) per call in {calls} calls: "
                f"{window}, other device events {others}"
            )
        if events == expected:
            return kernel_us / calls / 1e3, events / calls, seen
        if events and launch_calls == expected and (fullest is None or events > fullest[1]):
            fullest = (kernel_us, events, launch_calls)
    if short_ok and fullest is not None:
        kernel_us, events, launch_calls = fullest
        return kernel_us / events / 1e3, launch_calls / calls, seen
    if any(window["kernel_events"] for window in seen):
        raise AssertionError(f"{kernel}: no profiler window held {calls} launches: {seen}")
    return None, None, seen


def smi_sample() -> str:
    """The card's SM clock, power draw and power limit, now."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def phase_device() -> tuple[str, str]:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    print(f"device: {kind} | nvidia-smi: {smi}")
    from yoda_tpu_torch.ops import cuda_kernel

    t0 = time.monotonic()
    libs = cuda_kernel.build_all()
    print(f"built {', '.join(lib.name for lib in libs.values())} in "
          f"{time.monotonic() - t0:.2f} s (in parallel)")
    for lib in libs.values():
        log = lib.with_suffix(".log")
        if log.exists():
            for line in log.read_text().splitlines():
                if "registers" in line or "bytes stack" in line or "error" in line:
                    print(f"  ptxas {lib.stem}: {line.strip()}")
    return kind, smi


def round_trip_ms(chips, nodes, dyn, host_ok, reqs, calls: int = 30) -> dict:
    """Host wall time of TorchFleetKernel.evaluate_burst calls on the card
    (pack and upload the per-call inputs, launch, fetch, unpack), median ms
    per call: back to back ("hot"), after 5 ms of sleep ("after_sleep",
    host and card idle) and after 5 ms of host Python work that touches
    8 MB ("after_work", as a scheduling cycle does). "pack_hot" and
    "pack_after_sleep" time the host-only packing step (pack_inputs) alone
    the same ways, to tell a slower host from a slower card."""
    from yoda_tpu_torch.config import SchedulerConfig
    from yoda_tpu_torch.ops.arrays import FleetArrays
    from yoda_tpu_torch.ops.kernel import CHIP_KEYS, STATIC_NODE_KEYS, KernelRequest
    from yoda_tpu_torch.ops.kernel import TorchFleetKernel, pack_inputs, pack_request

    n_real = int(nodes[0].sum())
    fields = {key: chips[i].T for i, key in enumerate(CHIP_KEYS)}
    fields.update({key: nodes[i] for i, key in enumerate(STATIC_NODE_KEYS)})
    fields.update(
        names=[f"n{i}" for i in range(n_real)], fresh=dyn[0],
        reserved_chips=dyn[1], claimed_hbm_mib=dyn[2], host_ok=host_ok[0],
        last_updated=np.zeros(dyn.shape[1]),
    )
    kern = TorchFleetKernel(
        SchedulerConfig().effective_weights(), torch.device("cuda", 0)
    )
    kern.put_static(FleetArrays.from_numpy(fields))
    requests = [KernelRequest(*map(int, r)) for r in reqs]

    def work() -> None:
        end = time.perf_counter() + 0.005
        while time.perf_counter() < end:
            junk = bytearray(8 << 20)
            junk[:: 4096] = b"x" * len(junk[:: 4096])

    def evaluate() -> None:
        kern.evaluate_burst(dyn, host_ok, requests)

    def pack() -> None:
        pack_inputs(dyn, host_ok, np.stack([pack_request(r) for r in requests]))

    def sleep() -> None:
        time.sleep(0.005)

    out = {}
    for name, fn, gap in (
        ("hot", evaluate, None), ("after_sleep", evaluate, sleep),
        ("after_work", evaluate, work), ("pack_hot", pack, None),
        ("pack_after_sleep", pack, sleep),
    ):
        for _ in range(3):
            fn()
        times = []
        for _ in range(calls):
            if gap:
                gap()
            t = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t)
        out[name] = 1e3 * statistics.median(times)
    return out


def joint_case(k: int, n: int, seed: int):
    """Seeded joint-fit inputs: [K, 6, N] rows whose rows 0, 3, 5 are
    feasible / score / claimable, with heavy score ties (scores 0..3),
    gangs of 1-6 rows, the last K // 8 rows padding, and demands (up to 40
    chips against 0..8 claimable) that fail gangs at their first row,
    part-way and after an earlier gang fit."""
    from yoda_tpu_torch.ops.kernel import KernelRequest, joint_fit_vectors

    rng = np.random.default_rng(seed)
    packed = rng.integers(-9, 9, size=(k, 6, n)).astype(np.int32)
    packed[:, 0] = rng.random((k, n)) > 0.4
    packed[:, 3] = rng.integers(0, 4, size=(k, n))
    packed[:, 5] = rng.integers(0, 9, size=(k, n))
    m = k - k // 8
    offsets = [0]
    while offsets[-1] < m:
        offsets.append(min(m, offsets[-1] + int(rng.integers(1, 7))))
    requests = [
        KernelRequest(int(rng.choice([1, 2, 4, 8, 40])), 0, 0, 0, 0)
        for _ in range(m)
    ] + [KernelRequest(1, 0, 0, 0, 0)] * (k - m)
    return (packed, *joint_fit_vectors(requests, offsets))


def identical_rows_case(n_hosts: int = 5000, n: int = 8192, gangs: int = 8,
                        size: int = 16, seed: int = 31):
    """Run (c)'s plain gangs as the scan sees them: ``gangs`` gangs of
    ``size`` rows with the same feasibility and scores, each row demanding
    a whole 8-chip host on 8-chip hosts (claimable 8), with score ties."""
    from yoda_tpu_torch.ops.kernel import KernelRequest, joint_fit_vectors

    rng = np.random.default_rng(seed)
    packed = np.zeros((gangs * size, 6, n), dtype=np.int32)
    feas = np.zeros(n, dtype=np.int32)
    feas[:n_hosts] = rng.random(n_hosts) > 0.1
    packed[:, 0] = feas
    packed[:, 3] = rng.integers(0, 40, size=n)
    packed[:, 5] = 8 * (np.arange(n) < n_hosts)
    requests = [KernelRequest(8, 0, 0, 0, 0)] * (gangs * size)
    return (packed, *joint_fit_vectors(requests, list(range(0, gangs * size + 1, size))))


def slice_edge_case(k: int, n: int, slice_words: int, seed: int = 41):
    """Equal top scores on both sides of every slice edge e (nodes e - 1
    and e), e - 1 infeasible for the first gang's rows, one-chip demands
    on one-chip nodes."""
    from yoda_tpu_torch.ops.kernel import KernelRequest, joint_fit_vectors

    rng = np.random.default_rng(seed)
    packed = np.zeros((k, 6, n), dtype=np.int32)
    packed[:, 0] = rng.random((k, n)) > 0.05
    packed[:, 3] = rng.integers(0, 50, size=(k, n))
    packed[:, 5] = 1
    for e in range(slice_words, n, slice_words):
        packed[:, 3, e - 1] = packed[:, 3, e] = 1000
        packed[:, 0, e] = 1
        packed[: k // 2, 0, e - 1] = 0
    requests = [KernelRequest(1, 0, 0, 0, 0)] * k
    return (packed, *joint_fit_vectors(requests, [0, k // 2, k]))


def joint_bound_ms(k: int, n: int) -> float:
    """Least time for the scan: rows 0, 3 and 5 of [K, 6, N] read once, the
    three [K] side inputs read once, picks and verdicts [K] and the ledger
    [N] written once, over the memory rate (a few integer operations per
    element: the operations' time is far smaller)."""
    return (3 * k * n + 3 * k + 2 * k + n) * 4 / MEM_BYTES_PER_S * 1e3


def phase_joint_fit() -> list[dict]:
    """joint_fit against its plain version at the JOINT_SHAPES, on the
    identical-rows case and on ties across slice edges."""
    from yoda_tpu_torch.ops import cuda_kernel
    from yoda_tpu_torch.ops.cuda_kernel import joint_fit, joint_fit_plan
    from yoda_tpu_torch.ops.kernel import joint_fit_scan

    dev = torch.device("cuda", 0)
    cases = [((k, n), joint_case(k, n, seed=k * 7 + n)) for k, n in JOINT_SHAPES]
    cases.append(("identical rows", identical_rows_case()))
    edge_slice = joint_fit_plan(8192, dev)["slice"]
    cases.append(("slice-edge ties", slice_edge_case(64, 8192, edge_slice)))
    rows = []
    for name, case in cases:
        packed, chips, starts, valid = (torch.from_numpy(x).to(dev) for x in case)
        k, _, n = packed.shape
        got = joint_fit(packed, chips, starts, valid)

        def plain():
            return joint_fit_scan(
                packed[:, 0], packed[:, 3], packed[:, 5], chips, starts, valid
            )

        want = plain()
        torch.cuda.synchronize()
        err = max(
            int((g.long() - w.long()).abs().max()) if g.numel() else 0
            for g, w in zip(got, want)
        )
        if err or not all(torch.equal(g, w.to(torch.int32)) for g, w in zip(got, want)):
            raise AssertionError(f"joint_fit != plain on {name} (K={k} N={n}): max |diff| {err}")
        if name == "identical rows":
            feas, scores = case[0][0, 0], case[0][0, 3]
            order = sorted(np.flatnonzero(feas), key=lambda j: (-int(scores[j]), j))
            if got[0].cpu().tolist() != order[:k]:
                raise AssertionError("identical rows: a pick is not the next-best host")
        plan = joint_fit_plan(n, dev)
        if n == 65536 and not plan["shared_ledgers"]:
            raise AssertionError(f"ledgers in global memory at 65,536 nodes: {plan}")
        row = dict(
            case=name if isinstance(name, str) else "seeded", k=k, n=n,
            max_abs_err=err, tolerance=0, plan=plan,
            taken=int((got[0] >= 0).sum()), gangs_fit=int(got[1].sum()),
            bound_ms=joint_bound_ms(k, n),
            ms=cuda_ms(lambda: joint_fit(packed, chips, starts, valid)),
            plain_ms=cuda_ms(plain, warmup=1, iters=3),
        )
        row["device_ms"], row["launches_per_call"], row["profiler_windows"] = profiled_ms(
            lambda: joint_fit(packed, chips, starts, valid),
            lambda: cuda_kernel.joint_fit_launches, kernel="joint_fit",
        )
        if row["device_ms"] is not None:
            row["us_per_row"] = 1e3 * row["device_ms"] / k
        if name in ONE_BLOCK_DEVICE_MS:
            row["one_block_device_ms_earlier_run"] = ONE_BLOCK_DEVICE_MS[name]
        row["smi"] = smi_sample()
        rows.append(row)
        print("joint_fit", json.dumps(row))
    return rows


def phase_kernel() -> tuple[list[dict], dict]:
    from yoda_tpu_torch.config import SchedulerConfig
    from yoda_tpu_torch.ops import cuda_kernel
    from yoda_tpu_torch.ops.cuda_kernel import fleet_eval, launch_plan
    from yoda_tpu_torch.ops.kernel import kernel_packed_burst

    dev = torch.device("cuda", 0)
    weight_sets = {
        "least-allocated": SchedulerConfig().effective_weights(),
        "most-allocated": SchedulerConfig(
            scoring_strategy="most-allocated"
        ).effective_weights(),
    }
    rows = []
    cases = [(*s, CHIPS) for s in KERNEL_SHAPES + CHUNKED_SHAPES] + WIDE_SHAPES
    for n_real, n_pad, k, c in cases:
        chips, nodes, dyn = random_fleet(n_real, n_pad, seed=n_pad + k + c, chips=c)
        rng = np.random.default_rng(k)
        host_ok = (rng.random((k, n_pad)) > 0.2).astype(np.int32)
        if k > 1:
            host_ok[-1] = 0  # an all-False padding row
        reqs = REQUEST_TABLE[np.arange(k) % len(REQUEST_TABLE)]
        args = [
            torch.from_numpy(np.ascontiguousarray(x)).to(dev)
            for x in (chips, nodes, dyn, host_ok, reqs)
        ]
        for wname, w in weight_sets.items():
            got = fleet_eval(*args, w)
            want = kernel_packed_burst(*args, w)
            torch.cuda.synchronize()
            err = int((got.long() - want.long()).abs().max())
            if not torch.equal(got, want):
                bad = (got != want).nonzero()[:5].tolist()
                raise AssertionError(
                    f"kernel != plain at nodes={n_real} C={c} K={k} {wname}: "
                    f"max |diff| {err}, first [k, row, node] {bad}"
                )
            if k > 1 and int(got[-1, 0].sum()) != 0:
                raise AssertionError("padding row came out feasible")
            row = dict(
                nodes=n_real, padded=n_pad, k=k, chips=c, weights=wname,
                max_abs_err=err, tolerance=0,
            )
            row["bound_ms"], row["bound_by"] = bound(n_pad, k, c)
            wide = c > CHIPS
            if wname == "least-allocated" and not wide and (n_real, n_pad, k) in CHUNKED_SHAPES:
                row["ms"] = cuda_ms(lambda: fleet_eval(*args, w))
                row["smi"] = smi_sample()
            elif wname == "least-allocated":
                row["plan"] = launch_plan(n_pad, c, min(k, cuda_kernel.MAX_REQUESTS), dev)
                row["ms"] = cuda_ms(lambda: fleet_eval(*args, w))
                row["plain_ms"] = cuda_ms(
                    lambda: kernel_packed_burst(*args, w), iters=3 if wide else 10
                )
                if wide or (n_real, n_pad, k) in PROFILED_SHAPES:
                    (row["device_ms"], row["launches_per_call"],
                     row["profiler_windows"]) = profiled_ms(
                        lambda: fleet_eval(*args, w), lambda: cuda_kernel.launches,
                        per_call=-(-k // cuda_kernel.MAX_REQUESTS),
                    )
                    row["profiled"] = True
                    if n_pad == 8192 and not wide:
                        row["round_trips_ms"] = round_trip_ms(
                            chips, nodes, dyn, host_ok, reqs
                        )
                        row["round_trip_ms"] = row["round_trips_ms"]["hot"]
                row["smi"] = smi_sample()
            rows.append(row)
            print("kernel", json.dumps(row))
    main = [r for r in rows if r.get("profiled")]
    return rows, main


def fleet_and_pods(seed: int):
    """The 5,000-node fleet recipe and the 320-pod script."""
    rng = np.random.default_rng(seed)
    pods = []
    for i in range(64 + 256):
        labels = {}
        gen = rng.choice(["", "v5e", "v5p"], p=[0.5, 0.3, 0.2])
        if gen:
            labels["tpu/generation"] = str(gen)
        chips = int(rng.choice([1, 2, 4] if gen == "v5p" else [1, 2, 4, 8]))
        labels["tpu/chips"] = str(chips)
        if rng.random() < 0.6:
            top = 64 if gen == "v5p" else 12
            labels["tpu/hbm"] = f"{int(rng.integers(1, top))}Gi"
        if rng.random() < 0.25:
            labels["tpu/clock"] = "1000" if gen == "v5p" else "900"
        pods.append((f"pod-{i:03d}", labels))
    return pods[:64], pods[64:]


def run_main_path(platform: str, pods_a, pods_b) -> dict:
    """Runs (a) and (b) of the main path on one kernel_platform; returns
    the bindings, counters and latencies."""
    from yoda_tpu_torch.api.types import PodSpec
    from yoda_tpu_torch.ops import cuda_kernel

    out = {}
    for run, pods, burst in (("a", pods_a, 1), ("b", pods_b, 16)):
        stack, _agent = build_fleet(platform, burst)
        n_nodes = len(stack.informer.snapshot())
        for name, labels in pods:
            stack.cluster.create_pod(PodSpec(name, labels=dict(labels)))
        # Wall time inside the evaluation (uploads, kernel, result fetch),
        # against the whole run: the share of the cycle the device path
        # can move.
        kern = stack.batch._kern
        eval_s: list[float] = []

        def timed(*args, _inner=kern.evaluate_burst):
            t = time.monotonic()
            try:
                return _inner(*args)
            finally:
                eval_s.append(time.monotonic() - t)

        kern.evaluate_burst = timed
        cuda_kernel.launches = 0
        t0 = time.monotonic()
        stack.scheduler.run_until_idle(max_wall_s=600)
        if platform != "cpu":
            torch.cuda.synchronize()
        wall = time.monotonic() - t0
        launches = cuda_kernel.launches
        bound = {
            name: stack.cluster.get_pod(f"default/{name}").node_name
            for name, _ in pods
        }
        lat = sorted(
            r.latency_s for r in stack.scheduler.stats.results if r.outcome == "bound"
        )
        capacity = {
            t.name: sum(c.healthy for c in t.chips)
            for t in stack.cluster.list_tpu_metrics()
        }
        over = [
            h for h, cap in capacity.items()
            if stack.accountant.chips_in_use(h) > cap
        ]
        b = stack.batch
        out[run] = dict(
            platform=platform, nodes=n_nodes, pods=len(pods), burst=burst,
            bound=sum(v is not None for v in bound.values()), bindings=bound,
            overcommitted=over, launches=launches,
            dispatch_count=b.dispatch_count, burst_dispatches=b.burst_dispatches,
            burst_served=b.burst_served, **dispatch_health(b),
            **resident_counts(b),
            wall_s=wall, eval_s=sum(eval_s),
            eval_ms_per_call=1e3 * sum(eval_s) / max(len(eval_s), 1),
            eval_ms_median=1e3 * statistics.median(eval_s) if eval_s else None,
            pods_per_s=len(lat) / wall if wall else 0.0,
            p50_ms=1e3 * lat[len(lat) // 2] if lat else None,
            p99_ms=1e3 * lat[min(len(lat) - 1, int(0.99 * len(lat)))] if lat else None,
        )
    return out


def build_fleet(
    platform: str,
    burst: int,
    pools: "dict[str, str] | None" = None,
    *,
    node_fn=None,
    slices: int = 512,
    v5e_hosts: int = 2952,
    clock=None,
    now_fn=None,
    config=None,
    **knobs,
):
    """The 5,000-node fleet's stack and its agent: 512 v5p 2x2x1 slices and
    2,952 v5e hosts, published by the port's FakeTpuAgent. With ``pools``
    every host gets a Node object, labelled pool=<its pool> where ``pools``
    names it; with ``node_fn`` every host gets ``node_fn(name)``. Smaller
    fleets for the card tests through ``slices`` and ``v5e_hosts``; the
    stack's scheduling clock through ``clock``, the agent's wall clock
    through ``now_fn``; the SchedulerConfig through ``config`` (its
    platform replaced by ``platform``, ``burst`` ignored) or else built
    from ``burst``; other SchedulerConfig knobs through ``knobs``."""
    from yoda_tpu_torch.agent.fake_publisher import FakeTpuAgent
    from yoda_tpu_torch.api.types import K8sNode
    from yoda_tpu_torch.config import SchedulerConfig
    from yoda_tpu_torch.standalone import build_stack

    if config is not None:
        config = dataclasses.replace(config, kernel_platform=platform, **knobs)
    else:
        config = SchedulerConfig(kernel_platform=platform, batch_requests=burst, **knobs)
    stack = build_stack(config=config, **({} if clock is None else {"clock": clock}))
    agent = FakeTpuAgent(stack.cluster, **({} if now_fn is None else {"now_fn": now_fn}))
    hosts = []
    for s in range(slices):
        hosts += agent.add_slice(f"v5p-{s:03d}", generation="v5p", host_topology=(2, 2, 1))
    for h in range(v5e_hosts):
        agent.add_host(f"v5e-{h:04d}", generation="v5e", chips=8)
        hosts.append(f"v5e-{h:04d}")
    if pools is not None:
        node_fn = lambda name: K8sNode(  # noqa: E731
            name, labels={"pool": pools[name]} if name in pools else {}
        )
    if node_fn is not None:
        for name in hosts:
            stack.cluster.put_node(node_fn(name))
    agent.publish_all()
    if stack.ingestor is not None:
        stack.ingestor.flush()
    return stack, agent


def resident_counts(b) -> dict:
    """The resident fleet state's counters on a run's batch plugin. A run
    with one re-stack (the boot) reports that re-stack's wall ms, the
    fleet's first lowering and upload."""
    r = b._resident
    if r is None:
        raise AssertionError("the stack did not ride the resident fleet state")
    return dict(
        restacks=b.restacks, delta_syncs=r.delta_syncs, rows_applied=r.rows_applied,
        sets_retained=b.sets_retained, burst_invalidated=b.burst_invalidated,
        admission_reuse=b.admission_reuse, admission_patched=b.admission_patched,
        admission_rebuilds=b.admission_rebuilds,
        first_restack_ms=r.last_restack_ms if r.restacks == 1 else None,
    )


def dispatch_health(b) -> dict:
    """A batch plugin's dispatch chain counters: exceptions caught,
    dispatches completed on a demoted level and the circuit breaker's pin.
    Every run but (s) must read 0 in all three."""
    return dict(dispatch_errors=b.dispatch_errors, dispatch_fallbacks=b.dispatch_fallbacks,
                backend_level=b.backend_level)


def stack_dispatch(stack) -> dict:
    """:func:`dispatch_health` over a stack's batch plugins (either
    package's stack; none in loop mode)."""
    rows = [dispatch_health(p) for p in stack.framework.batch_plugins]
    return dict(dispatch_errors=sum(r["dispatch_errors"] for r in rows),
                dispatch_fallbacks=sum(r["dispatch_fallbacks"] for r in rows),
                backend_level=max((r["backend_level"] for r in rows), default=0))


def demoted(r: dict) -> str:
    """What a record's dispatch chain counters say went wrong ("" when all
    three are 0)."""
    keys = ("dispatch_errors", "dispatch_fallbacks", "backend_level")
    return ", ".join(f"{k} {r[k]}" for k in keys if r.get(k))


class DispatchWatch:
    """While installed, every batch plugin dispatch in this process is
    watched (``YodaBatch._dispatch`` wrapped): the exceptions it caught,
    the dispatches it completed on a demoted level and the highest circuit
    breaker pin, over every plugin, whichever run built it. ``main``
    requires all three to stay 0 through every phase before run (s); (p1)'s
    worker processes report theirs."""

    def install(self) -> "DispatchWatch":
        from yoda_tpu_torch.plugins.yoda.batch import YodaBatch

        self.cls, self.real = YodaBatch, YodaBatch._dispatch
        self.lock = threading.Lock()
        self.counts = dict(dispatch_errors=0, dispatch_fallbacks=0, backend_level=0)
        real, watch = self.real, self

        def _dispatch(plugin, static, call):
            errors, fallbacks = plugin.dispatch_errors, plugin.dispatch_fallbacks
            try:
                return real(plugin, static, call)
            finally:
                with watch.lock:
                    c = watch.counts
                    c["dispatch_errors"] += plugin.dispatch_errors - errors
                    c["dispatch_fallbacks"] += plugin.dispatch_fallbacks - fallbacks
                    c["backend_level"] = max(c["backend_level"], plugin.backend_level)

        YodaBatch._dispatch = _dispatch
        return self

    def restore(self) -> None:
        self.cls._dispatch = self.real

    def check(self, what: str) -> None:
        bad = demoted(self.counts)
        if bad:
            raise AssertionError(f"{what}: a dispatch demoted outside run (s): {bad}")


def gang_script(seed: int, *, plain: int = 8, plain_size: int = 16,
                cosched: int = 4, topo: int = 16, multi: int = 4, singles: int = 64):
    """Run (c)'s two waves of (name, labels, node selector) and the gang
    each gang member belongs to (name -> (kind, size)). The counts cut the
    script for smaller fleets (run (o) on the CPU); the defaults are run
    (c)'s."""
    rng = np.random.default_rng(seed)
    single_pods = fleet_and_pods(seed)[0][:singles]  # drawn as for run (a)
    gangs: dict[str, tuple[str, int]] = {}

    def members(name, kind, labels, size):
        gangs[name] = (kind, size)
        return [(f"{name}-{i:02d}", dict(labels), None) for i in range(size)]

    wave1, wave2 = [], []
    for g in range(plain):
        wave1 += members(f"plain{g}", "plain", {
            "tpu/gang": f"plain{g}", "tpu/gang-size": str(plain_size), "tpu/chips": "8",
            "tpu/generation": "v5e"}, plain_size)
    for g in range(cosched):
        wave1 += members(f"cosched{g}", "cosched", {
            "pod-group.scheduling.sigs.k8s.io/name": f"cosched{g}",
            "pod-group.scheduling.sigs.k8s.io/min-available": "4",
            "tpu/chips": "4"}, 4)
    for g in range(topo):
        wave2 += members(f"topo{g}", "topology", {
            "tpu/gang": f"topo{g}", "tpu/topology": "2x2x1", "tpu/chips": "4",
            "tpu/generation": "v5p"}, 4)
    for g in range(multi):
        wave2 += members(f"multi{g}", "multislice", {
            "tpu/gang": f"multi{g}", "tpu/topology": "2x2x1",
            "tpu/multislice": "2", "tpu/chips": "4"}, 8)
    half = len(single_pods) // 2
    wave1 += [(f"s{n}", labels, None) for n, labels in single_pods[:half]]
    wave2 += [(f"s{n}", labels, None) for n, labels in single_pods[half:]]
    waves = [[w[i] for i in rng.permutation(len(w))] for w in (wave1, wave2)]
    return waves, gangs


def contended_script():
    """Run (d): 4 plain v5e gangs of 16 x 8 chips selecting pool=contended."""
    gangs, pods = {}, []
    for g in range(4):
        name = f"cont{g}"
        gangs[name] = ("plain", 16)
        labels = {"tpu/gang": name, "tpu/gang-size": "16", "tpu/chips": "8",
                  "tpu/generation": "v5e"}
        pods += [(f"{name}-{i:02d}", dict(labels), {"pool": "contended"})
                 for i in range(16)]
    return [pods], gangs


def run_gang_path(platform: str, run: str) -> dict:
    """Run (c) or (d) on one kernel_platform; the bindings, counters and
    latencies."""
    from yoda_tpu_torch.api.types import K8sNode, PodSpec
    from yoda_tpu_torch.ops import cuda_kernel

    stack, _agent = build_fleet(platform, 16)
    if run == "c":
        waves, gangs = gang_script(seed=1)
    else:
        waves, gangs = contended_script()
        for h in range(52):
            stack.cluster.put_node(
                K8sNode(f"v5e-{h * 37:04d}", labels={"pool": "contended"})
            )
    kern = stack.batch._kern
    eval_s: list[float] = []
    fleet_calls: list[int] = []
    joint_inputs: list[tuple] = []

    def timed(inner):
        def call(*args, **kw):
            t = time.monotonic()
            try:
                return inner(*args, **kw)
            finally:
                eval_s.append(time.monotonic() - t)
        return call

    kern.evaluate_burst = timed(kern.evaluate_burst)
    kern.evaluate_joint_plan = timed(kern.evaluate_joint_plan)
    real_fleet_eval, real_joint_fit = cuda_kernel.fleet_eval, cuda_kernel.joint_fit

    def counted_fleet_eval(*args, **kw):
        fleet_calls.append(args[4].shape[0])
        return real_fleet_eval(*args, **kw)

    def kept_joint_fit(packed, *side, **kw):
        if packed.is_cuda:
            joint_inputs.append(tuple(t.clone() for t in (packed, *side)))
        return real_joint_fit(packed, *side, **kw)

    cuda_kernel.fleet_eval, cuda_kernel.joint_fit = counted_fleet_eval, kept_joint_fit
    cuda_kernel.launches = cuda_kernel.joint_fit_launches = 0
    t0 = time.monotonic()
    try:
        for wave in waves:
            for name, labels, selector in wave:
                stack.cluster.create_pod(
                    PodSpec(name, labels=labels, node_selector=selector or {})
                )
            stack.scheduler.run_until_idle(max_wall_s=600)
        if platform != "cpu":
            torch.cuda.synchronize()
    finally:
        cuda_kernel.fleet_eval, cuda_kernel.joint_fit = real_fleet_eval, real_joint_fit
    wall = time.monotonic() - t0
    launches, joint_launches = cuda_kernel.launches, cuda_kernel.joint_fit_launches
    pods = [name for wave in waves for name, _, _ in wave]
    bound = bindings_of(stack, pods)
    lat, completion = bind_latencies(
        stack.scheduler.stats.results,
        {name: labels for wave in waves for name, labels, _ in wave}, bound,
    )
    capacity = {
        t.name: sum(c.healthy for c in t.chips) for t in stack.cluster.list_tpu_metrics()
    }
    slice_of = {t.name: t.slice_id for t in stack.cluster.list_tpu_metrics()}
    b = stack.batch
    verdicts = {}
    for g, (kind, size) in gangs.items():
        nodes = [bound[n] for n in pods if n.startswith(f"{g}-")]
        verdicts[g] = dict(
            kind=kind, bound=sum(x is not None for x in nodes), size=size,
            hosts=len({x for x in nodes if x}),
            slices=len({slice_of[x] for x in nodes if x}),
            reserved=sum(
                stack.accountant.chips_in_use(x) for x in {x for x in nodes if x}
            ),
        )
    return dict(
        platform=platform, run=run, pods=len(pods),
        bound=sum(v is not None for v in bound.values()), bindings=bound,
        verdicts=verdicts,
        overcommitted=[h for h, c in capacity.items() if stack.accountant.chips_in_use(h) > c],
        launches=launches, fleet_calls=len(fleet_calls),
        chunks=sum(-(-k // cuda_kernel.MAX_REQUESTS) for k in fleet_calls),
        max_rows=max(fleet_calls, default=0), joint_fit_launches=joint_launches,
        waiting=len(stack.framework.waiting_pods()),
        **{c: getattr(b, c) for c in GANG_COUNTERS},
        **resident_counts(b),
        wall_s=wall, eval_s=sum(eval_s),
        eval_ms_per_call=1e3 * sum(eval_s) / max(len(eval_s), 1),
        pods_per_s=len(lat) / wall if wall else 0.0,
        p50_ms=pct_ms(lat, 0.5), p99_ms=pct_ms(lat, 0.99),
        gang_p50_ms=pct_ms(completion, 0.5), gang_p99_ms=pct_ms(completion, 0.99),
        joint_inputs=joint_inputs,
    )


GANG_COUNTERS = (
    "dispatch_count", "burst_dispatches", "burst_served", "gang_burst_dispatches",
    "gang_burst_served", "joint_dispatches", "joint_gangs", "joint_parked",
    "fused_plan_dispatches", "plan_served", "dispatch_errors", "dispatch_fallbacks",
    "backend_level",
)


def pct_ms(sorted_s: list[float], q: float) -> float | None:
    """The q-quantile (nearest rank below) of sorted seconds, in ms."""
    if not sorted_s:
        return None
    return 1e3 * sorted_s[min(len(sorted_s) - 1, int(q * len(sorted_s)))]


def bindings_of(stack, pods: list[str]) -> dict:
    """Each pod's node, None while pending, "evicted" once preemption took
    it."""
    out = {}
    for name in pods:
        pod = stack.cluster.get_pod(f"default/{name}")
        out[name] = "evicted" if pod is None else pod.node_name
    return out


def bind_latencies(results, labels_of: dict, bound: dict) -> tuple[list, list]:
    """Sorted per-pod latencies and per-gang completion times, seconds on
    the scheduler's clock, of the pods in ``labels_of``: a pod's first cycle
    start to its bind — its own "bound" cycle, or for a gang member the end
    of the cycle whose Permit released the gang (the last member's)."""
    from yoda_tpu_torch.api.requests import gang_name_of

    first: dict[str, float] = {}
    span: dict[str, tuple[float, float]] = {}
    bound_at: dict[str, float] = {}
    for r in results:
        name = r.pod_key.split("/", 1)[1]
        if name not in labels_of:
            continue
        first.setdefault(name, r.completed_at - r.latency_s)
        g = gang_name_of(labels_of[name])
        if g is not None and bound[name] not in (None, "evicted"):
            lo, hi = span.get(g, (float("inf"), 0.0))
            span[g] = (min(lo, first[name]), max(hi, r.completed_at))
        elif r.outcome == "bound":
            bound_at[name] = r.completed_at
    for name, labels in labels_of.items():
        g = gang_name_of(labels)
        if g in span and bound[name] not in (None, "evicted"):
            bound_at[name] = span[g][1]
    lat = sorted(bound_at[n] - first[n] for n in bound_at)
    completion = sorted(hi - lo for lo, hi in span.values())
    return lat, completion


def joint_device_ms(inputs: list[tuple]) -> tuple[float | None, list[dict]]:
    """joint_fit's device time per call on the inputs a run gave it, from a
    profiler window of 20 calls per input (after the run's counts were
    read: these launches are not the main path's), and the windows the
    profiler opened."""
    from yoda_tpu_torch.ops import cuda_kernel

    total, seen = 0.0, []
    for args in inputs:
        ms, _per_call, windows = profiled_ms(
            lambda: cuda_kernel.joint_fit(*args), lambda: cuda_kernel.joint_fit_launches,
            kernel="joint_fit", short_ok=True,
        )
        seen += windows
        if ms is None:
            return None, seen
        total += ms
    return (total / len(inputs) if inputs else None), seen


def check_gang_run(g: dict, c: dict) -> None:
    run = g["run"]
    if g["bindings"] != c["bindings"]:
        diff = [p for p in g["bindings"] if g["bindings"][p] != c["bindings"][p]]
        raise AssertionError(
            f"run {run}: {len(diff)} pods bound differently on cuda vs cpu, "
            f"e.g. {diff[:3]}"
        )
    if g["overcommitted"]:
        raise AssertionError(f"run {run}: over-committed {g['overcommitted']}")
    if demoted(g):
        raise AssertionError(f"run {run}: {demoted(g)}")
    if g["waiting"]:
        raise AssertionError(f"run {run}: {g['waiting']} pods left at Permit")
    for name, v in g["verdicts"].items():
        if v["bound"] not in (0, v["size"]):
            raise AssertionError(f"run {run}: gang {name} split: {v}")
        if v["bound"] and v["kind"] in ("topology", "multislice"):
            want_slices = 1 if v["kind"] == "topology" else 2
            if v["hosts"] != v["size"] or v["slices"] != want_slices:
                raise AssertionError(f"run {run}: gang {name} misplaced: {v}")
    if not 0 < g["fleet_calls"] == g["dispatch_count"]:
        raise AssertionError(
            f"run {run}: {g['fleet_calls']} fleet_eval calls for "
            f"{g['dispatch_count']} dispatches"
        )
    if g["launches"] != g["chunks"]:
        raise AssertionError(
            f"run {run}: {g['launches']} fleet_eval launches for {g['chunks']} chunks"
        )
    if not 0 < g["joint_fit_launches"] == g["fused_plan_dispatches"]:
        raise AssertionError(
            f"run {run}: {g['joint_fit_launches']} joint_fit launches for "
            f"{g['fused_plan_dispatches']} fused dispatches"
        )
    if c["launches"] or c["joint_fit_launches"]:
        raise AssertionError(f"run {run}: the CPU run launched a kernel")
    bound_pods = sum(v is not None for v in g["bindings"].values())
    if run == "c" and bound_pods != g["pods"]:
        raise AssertionError(f"run c: {bound_pods}/{g['pods']} pods bound")
    if run == "d":
        parked = [n for n, v in g["verdicts"].items() if v["bound"] == 0]
        if len(parked) != 1 or g["joint_parked"] < 1 or bound_pods != 48:
            raise AssertionError(
                f"run d: parked {parked}, joint_parked {g['joint_parked']}, "
                f"{bound_pods} bound (want one gang parked, 48 bound)"
            )
        if g["verdicts"][parked[0]]["reserved"]:
            raise AssertionError("run d: the parked gang holds reservations")


def phase_gang_path(smi: str) -> dict:
    out = {}
    for run in ("c", "d"):
        g = run_gang_path("auto", run)
        inputs = g.pop("joint_inputs")
        g["joint_fit_device_ms"], g["joint_fit_profiler_windows"] = joint_device_ms(inputs)
        g["joint_fit_rows"] = [int(args[0].shape[0]) for args in inputs]
        if g["joint_fit_device_ms"] is not None and inputs:
            g["joint_fit_us_per_row"] = (
                1e3 * g["joint_fit_device_ms"] * len(inputs) / sum(g["joint_fit_rows"])
            )
        g["joint_fit_one_block_device_ms_earlier_run"] = ONE_BLOCK_DEVICE_MS[f"run {run}"]
        c = run_gang_path("cpu", run)
        c.pop("joint_inputs")
        summary = {
            k: v for k, v in g.items() if k not in ("bindings", "verdicts")
        }
        print(f"gang path ({run}) cuda [{smi}]:", json.dumps(summary))
        print(
            f"gang path ({run}) cpu plain: bound {c['bound']}/{c['pods']}, "
            f"pods/s {c['pods_per_s']:.1f}, p50 {c['p50_ms']:.2f} ms, "
            f"p99 {c['p99_ms']:.2f} ms, gang p50 {c['gang_p50_ms']:.2f} ms, "
            f"gang p99 {c['gang_p99_ms']:.2f} ms, evaluation {c['eval_s']:.3f} s "
            f"of {c['wall_s']:.3f} s"
        )
        check_gang_run(g, c)
        out[run] = g
    return out


def phase_main_path(smi: str) -> dict:
    pods_a, pods_b = fleet_and_pods(seed=0)
    gpu = run_main_path("auto", pods_a, pods_b)
    cpu = run_main_path("cpu", pods_a, pods_b)
    for run in ("a", "b"):
        g, c = gpu[run], cpu[run]
        summary = {k: v for k, v in g.items() if k not in ("bindings",)}
        print(f"main path ({run}) cuda [{smi}]:", json.dumps(summary))
        print(
            f"main path ({run}) cpu plain: bound {c['bound']}/{c['pods']}, "
            f"pods/s {c['pods_per_s']:.1f}, p50 {c['p50_ms']:.2f} ms, "
            f"p99 {c['p99_ms']:.2f} ms, evaluation {c['eval_s']:.3f} s of "
            f"{c['wall_s']:.3f} s"
        )
        if g["nodes"] != 5000:
            raise AssertionError(f"fleet has {g['nodes']} nodes, not 5000")
        if g["bound"] != g["pods"]:
            raise AssertionError(f"run {run}: {g['bound']}/{g['pods']} pods bound")
        if g["overcommitted"]:
            raise AssertionError(f"run {run}: over-committed {g['overcommitted']}")
        if demoted(g):
            raise AssertionError(f"run {run}: {demoted(g)}")
        if not 0 < g["launches"] == g["dispatch_count"]:
            raise AssertionError(
                f"run {run}: {g['launches']} kernel launches for "
                f"{g['dispatch_count']} dispatches"
            )
        if c["launches"]:
            raise AssertionError(f"run {run}: the CPU run launched the kernel")
        if g["bindings"] != c["bindings"]:
            diff = [p for p in g["bindings"] if g["bindings"][p] != c["bindings"][p]]
            raise AssertionError(
                f"run {run}: {len(diff)} pods bound differently on cuda vs "
                f"cpu, e.g. {diff[:3]}"
            )
    if not gpu["b"]["burst_dispatches"]:
        raise AssertionError("run b made no burst dispatch")
    return gpu


UPDATE_FLEETS = [(5000, 8192), (65536, 65536)]  # (real nodes, padded nodes)
UPDATE_ROWS = [1, 3, 64, 2048]
UPDATE_MAIN_SHAPE = (8192, 64)  # (padded nodes, rows) in the kernels line


def fleet_arrays(chips, nodes, dyn):
    """A FleetArrays host mirror of a :func:`random_fleet` in the device
    layout."""
    from yoda_tpu_torch.ops.arrays import FleetArrays
    from yoda_tpu_torch.ops.kernel import CHIP_KEYS, STATIC_NODE_KEYS

    n_real = int(nodes[0].sum())
    fields = {key: chips[i].T for i, key in enumerate(CHIP_KEYS)}
    fields.update({key: nodes[i] for i, key in enumerate(STATIC_NODE_KEYS)})
    fields.update(
        names=[f"n{i}" for i in range(n_real)], fresh=dyn[0],
        reserved_chips=dyn[1], claimed_hbm_mib=dyn[2], host_ok=dyn[0],
        last_updated=np.zeros(dyn.shape[1]),
    )
    return FleetArrays.from_numpy(fields)


def update_rows_case(n_real: int, r: int, seed: int) -> list[int]:
    """``r`` distinct rows in a ragged (unsorted) order, row 0 and the last
    real row among them when ``r`` allows."""
    rng = np.random.default_rng(seed)
    ends = [0, n_real - 1][:r]
    middle = rng.choice(np.arange(1, n_real - 1), size=r - len(ends), replace=False)
    rows = [int(x) for x in middle] + ends
    return [rows[i] for i in rng.permutation(len(rows))]


def update_bound_ms(r: int, c: int = CHIPS) -> float:
    """Least time for a row update: the rows' payload read once and the
    rows written once, 2 x R x (9 C + 4) int32 words, over the memory
    rate."""
    return 2 * r * (9 * c + 4) * 4 / MEM_BYTES_PER_S * 1e3


def update_rows_check(n_real: int, n_pad: int, r: int, dev: torch.device):
    """One case of the row-update phase: a seeded fleet uploaded whole,
    ``r`` rows (update_rows_case) refilled on the host from another seed
    and applied with TorchFleetKernel.update_rows, then held against a
    fresh put_static of the refilled fleet, tolerance 0. Returns (the
    updated kernel, the fresh one, the refilled arrays, the rows, the
    largest absolute difference between the two)."""
    from yoda_tpu_torch.config import SchedulerConfig
    from yoda_tpu_torch.ops.kernel import CHIP_KEYS, STATIC_NODE_KEYS, TorchFleetKernel

    weights = SchedulerConfig().effective_weights()
    arrays = fleet_arrays(*random_fleet(n_real, n_pad, seed=n_pad))
    new = fleet_arrays(*random_fleet(n_real, n_pad, seed=n_pad + 1))
    rows = update_rows_case(n_real, r, seed=n_pad + r)
    kern = TorchFleetKernel(weights, dev)
    kern.put_static(arrays)
    before = kern._chips.clone()
    for key in CHIP_KEYS + STATIC_NODE_KEYS:
        getattr(arrays, key)[rows] = getattr(new, key)[rows]
    kern.update_rows(arrays, rows)
    fresh = TorchFleetKernel(weights, dev)
    fresh.put_static(arrays)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    err = max(
        int((kern._chips - fresh._chips).abs().max()),
        int((kern._nodes - fresh._nodes).abs().max()),
    )
    if err:
        raise AssertionError(f"update_rows != put_static at {n_pad} nodes, {r} rows: {err}")
    changed = (kern._chips != before).any(dim=0).any(dim=0).nonzero().flatten()
    if not set(changed.tolist()) <= set(rows):
        raise AssertionError(f"update_rows wrote outside its rows at {n_pad} nodes, {r} rows")
    return kern, fresh, arrays, rows, err


def phase_update_rows() -> list[dict]:
    """TorchFleetKernel.update_rows against a fresh put_static at every
    fleet and row set (update_rows_check), with the times of both and of
    the index_copy_ pair alone on a payload already on the card."""
    from yoda_tpu_torch.ops.kernel import apply_row_update, pack_row_update

    dev = torch.device("cuda", 0)
    out = []
    for n_real, n_pad in UPDATE_FLEETS:
        for r in UPDATE_ROWS:
            kern, fresh, arrays, rows, err = update_rows_check(n_real, n_pad, r, dev)
            payload = torch.from_numpy(pack_row_update(arrays, rows)).to(dev)
            row = dict(
                nodes=n_real, padded=n_pad, rows=r, max_abs_err=err, tolerance=0,
                ms=cuda_ms(lambda: kern.update_rows(arrays, rows)),
                put_static_ms=cuda_ms(lambda: fresh.put_static(arrays), iters=10),
                library_ms=cuda_ms(
                    lambda: apply_row_update(kern._chips, kern._nodes, payload, r)
                ),
                bound_ms=update_bound_ms(r),
            )
            row["bound_share"] = row["bound_ms"] / row["ms"]
            row["smi"] = smi_sample()
            out.append(row)
            print("update_rows", json.dumps(row))
    return out


def churn_flip_hosts(b, rng, names: list[str], event: int) -> list[str]:
    """The 4 hosts of a health-flip event: with a live burst set, the even
    ``event``s (counted over events that found a live set) take 4 hosts
    the set does not reference (infeasible for every remaining entry,
    untouched by its ledger: the set is retained) and the odd ones 2
    referenced and 2 unreferenced (the set drops); with none, 4 seeded
    hosts."""
    burst = b._burst
    if burst is None:
        return [names[i] for i in rng.choice(len(names), 4, replace=False)]
    mask = np.zeros(len(burst.names), dtype=bool)
    for e in burst.entries.values():
        mask |= e.result.feasible[: len(burst.names)].astype(bool)
    live = set(names)
    refd = [nm for i, nm in enumerate(burst.names)
            if (mask[i] or nm in burst.consumed) and nm in live]
    unref = [nm for i, nm in enumerate(burst.names)
             if not mask[i] and nm not in burst.consumed and nm in live]
    take_ref = 0 if event % 2 == 0 else min(2, len(refd))
    take_unref = min(4 - take_ref, len(unref))
    pick = [refd[i] for i in rng.choice(len(refd), take_ref, replace=False)]
    pick += [unref[i] for i in rng.choice(len(unref), take_unref, replace=False)]
    return pick


def run_churn(platform: str, pods, *, classic: bool = False) -> dict:
    """Run (e): ``pods`` singletons at batch_requests 16 on the 5,000-node
    fleet, drained loop turn by loop turn and cycle by cycle. Between loop
    turns the agent republishes every host bound during the turn (a
    value-changing CR: the bound pod's HBM is now charged); every 8th
    cycle it flips one chip's health on 4 hosts (churn_flip_hosts); at
    the first turn boundary past half the pods it removes one idle v5e
    host (a structural delta). A republish of a bound host lands between
    turns because mid-turn it would always drop the live burst set (the
    host is in its ledger), leaving the retention branch unreachable.
    ``classic`` unsets the four delta feeds after build_stack: the classic
    per-version refresh, for comparison only."""
    from yoda_tpu_torch.api.types import PodSpec
    from yoda_tpu_torch.ops import cuda_kernel
    from yoda_tpu_torch.ops import kernel as kernel_mod
    from yoda_tpu_torch.ops.arrays import FleetArrays
    from yoda_tpu_torch.ops.kernel import stack_static

    stack, agent = build_fleet(platform, 16)
    b, inf = stack.batch, stack.informer
    if classic:
        b.changes_fn = b.reserved_delta_fn = None
        b.claimed_delta_fn = b.admission_changes_fn = None
    for name, labels in pods:
        stack.cluster.create_pod(PodSpec(name, labels=dict(labels)))
    names = sorted(t.name for t in stack.cluster.list_tpu_metrics())
    timers: dict[str, list[float]] = {"eval": [], "dyn": [], "admission": [], "refresh": []}

    def timed(key, inner):
        def call(*args, **kw):
            t = time.perf_counter()
            try:
                return inner(*args, **kw)
            finally:
                timers[key].append(time.perf_counter() - t)
        return call

    b._kern.evaluate_burst = timed("eval", b._kern.evaluate_burst)
    b._dyn_for = timed("dyn", b._dyn_for)
    b._admission_vec = timed("admission", b._admission_vec)
    b._refresh_static = timed("refresh", b._refresh_static)
    rng = np.random.default_rng(7)
    sched, queue = stack.scheduler, stack.scheduler.queue
    state = dict(cycle=0, flips=0, live_flips=0, republishes=0, expected_rows=0,
                 syncs=(0, 0))
    pending: set[str] = set()   # hosts changed since the last sync
    delta_ms: list[float] = []
    first_restack_ms = None
    removed = None

    def publish(host: str) -> None:
        before = inf.metrics_version
        agent.refresh(host)
        if inf.metrics_version != before:
            pending.add(host)
            state["republishes"] += 1

    def note_sync() -> None:
        nonlocal first_restack_ms
        r = b._resident
        if r is None:
            return
        if first_restack_ms is None and r.restacks:
            first_restack_ms = r.last_restack_ms
        syncs = (r.delta_syncs, r.restacks)
        if syncs == state["syncs"]:
            return
        if r.restacks != state["syncs"][1]:
            pending.clear()  # the re-stack absorbed them
        else:
            state["expected_rows"] += len(pending)
            pending.clear()
            delta_ms.append(r.last_delta_ms)
        state["syncs"] = syncs

    def bound_hosts() -> set:
        return {p.node_name for p in stack.cluster.list_pods() if p.node_name}

    cuda_kernel.launches = kernel_mod.row_update_launches = 0
    seen, bound_at_retry = bound_hosts(), -1
    t0 = time.monotonic()
    while True:
        for host in sorted(bound_hosts() - seen):
            publish(host)
        seen = bound_hosts()
        n_bound = sum(1 for p in stack.cluster.list_pods() if p.node_name)
        if removed is None and n_bound >= len(pods) // 2:
            removed = next(
                nm for nm in names if nm.startswith("v5e")
                and stack.accountant.chips_in_use(nm) == 0 and nm not in seen
            )
            agent.remove_host(removed)
            names.remove(removed)
        qpi = queue.pop(timeout=0)
        if qpi is None:
            if not queue.pending_retry_count() or n_bound == bound_at_retry:
                break
            bound_at_retry = n_bound
            queue.move_all_to_active(force=True)
            continue
        batch = sched._pop_batch(qpi)
        note_sync()
        for q in batch:
            sched.schedule_one(q)
            note_sync()
            state["cycle"] += 1
            if state["cycle"] % 8 == 0:
                live = b._burst is not None
                for host in churn_flip_hosts(b, rng, names, state["live_flips"]):
                    chip = int(rng.integers(0, 4))
                    h = agent._hosts[host]
                    agent.set_chip_health(host, chip, chip in h.unhealthy)
                    publish(host)
                state["flips"] += 1
                state["live_flips"] += live
    if platform != "cpu":
        torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches, row_launches = cuda_kernel.launches, kernel_mod.row_update_launches
    bindings = {name: stack.cluster.get_pod(f"default/{name}").node_name for name, _ in pods}
    lat = sorted(r.latency_s for r in sched.stats.results if r.outcome == "bound")
    # Against every chip of a host: a health flip may take a chip out from
    # under a pod that is already running there.
    capacity = {t.name: len(t.chips) for t in stack.cluster.list_tpu_metrics()}
    over = [h for h, cap in capacity.items() if stack.accountant.chips_in_use(h) > cap]
    out = dict(
        platform=platform, classic=classic, pods=len(pods),
        bound=sum(v is not None for v in bindings.values()), bindings=bindings,
        overcommitted=over, cycles=state["cycle"], flip_events=state["flips"],
        live_set_flip_events=state["live_flips"],
        republishes=state["republishes"], removed_host=removed,
        launches=launches, row_update_launches=row_launches,
        dispatch_count=b.dispatch_count, burst_dispatches=b.burst_dispatches,
        burst_served=b.burst_served, burst_invalidated=b.burst_invalidated,
        sets_retained=b.sets_retained, restacks=b.restacks,
        **dispatch_health(b),
        admission_reuse=b.admission_reuse, admission_patched=b.admission_patched,
        admission_rebuilds=b.admission_rebuilds,
        wall_s=wall, pods_per_s=len(lat) / wall if wall else 0.0,
        p50_ms=1e3 * lat[len(lat) // 2] if lat else None,
        p99_ms=1e3 * lat[min(len(lat) - 1, int(0.99 * len(lat)))] if lat else None,
        eval_ms_per_call=1e3 * statistics.mean(timers["eval"]) if timers["eval"] else None,
        refresh_ms_per_call=1e3 * statistics.mean(timers["refresh"]),
        dyn_ms_per_dispatch=1e3 * sum(timers["dyn"]) / max(b.dispatch_count, 1),
        admission_ms_per_dispatch=1e3 * sum(timers["admission"]) / max(b.dispatch_count, 1),
    )
    r = b._resident
    if r is not None:
        out.update(
            delta_syncs=r.delta_syncs, rows_applied=r.rows_applied,
            expected_rows=state["expected_rows"],
            delta_sync_ms_median=statistics.median(delta_ms) if delta_ms else None,
            first_restack_ms=first_restack_ms, last_restack_ms=r.last_restack_ms,
        )
        # One closing sync brings the resident state to the final snapshot;
        # it must equal a cold lowering and upload of that snapshot.
        snap = inf.snapshot()
        b._refresh_static(snap)
        chips, nodes = stack_static(FleetArrays.from_snapshot(snap))
        out["resident_equals_cold"] = bool(
            torch.equal(b._kern._chips.cpu(), torch.from_numpy(chips))
            and torch.equal(b._kern._nodes.cpu(), torch.from_numpy(nodes))
        )
    return out


def check_churn(g: dict, c: dict) -> None:
    if g["bound"] != g["pods"]:
        raise AssertionError(f"run e: {g['bound']}/{g['pods']} pods bound")
    if g["bindings"] != c["bindings"]:
        diff = [p for p in g["bindings"] if g["bindings"][p] != c["bindings"][p]]
        raise AssertionError(f"run e: {len(diff)} pods bound differently on cuda vs cpu")
    for run in (g, c):
        name = f"run e ({run['platform']})"
        if run["overcommitted"]:
            raise AssertionError(f"{name}: over-committed {run['overcommitted']}")
        if run["restacks"] != 2:
            raise AssertionError(f"{name}: {run['restacks']} re-stacks, want 2")
        if not run["delta_syncs"] or run["rows_applied"] != run["expected_rows"]:
            raise AssertionError(
                f"{name}: {run['delta_syncs']} delta syncs, {run['rows_applied']} rows "
                f"applied for {run['expected_rows']} value-changing republishes"
            )
        if not (run["sets_retained"] > 0 and run["burst_invalidated"] > 0):
            raise AssertionError(
                f"{name}: sets_retained {run['sets_retained']}, burst_invalidated "
                f"{run['burst_invalidated']} (want both branches of _retain_set)"
            )
        if demoted(run):
            raise AssertionError(f"{name}: {demoted(run)}")
        if not run["resident_equals_cold"]:
            raise AssertionError(f"{name}: resident tensors != cold put_static")
    if not 0 < g["launches"] == g["dispatch_count"]:
        raise AssertionError(
            f"run e: {g['launches']} fleet_eval launches for {g['dispatch_count']} dispatches"
        )
    if g["row_update_launches"] != g["delta_syncs"]:
        raise AssertionError(
            f"run e: {g['row_update_launches']} row updates for {g['delta_syncs']} delta syncs"
        )
    if c["launches"] or c["row_update_launches"]:
        raise AssertionError("run e: the CPU run launched on the card")


def phase_churn(smi: str) -> dict:
    pods = fleet_and_pods(seed=2)[1]  # 256 singletons, drawn as run (b)'s
    g = run_churn("auto", pods)
    c = run_churn("cpu", pods)
    classic = run_churn("auto", pods, classic=True)
    for run in (g, c, classic):
        summary = {k: v for k, v in run.items() if k != "bindings"}
        print(f"churn (e) {run['platform']}{' classic' if run['classic'] else ''} [{smi}]:",
              json.dumps(summary))
    check_churn(g, c)
    return g


# Run (f)'s pools on the 5,000-node fleet: 64 v5e hosts (512 chips) and 4
# v5p-32 slices (16 hosts x 4 chips).
MIXED_E = [f"v5e-{h * 41:04d}" for h in range(64)]
MIXED_P = [f"v5p-{s * 128:03d}-{i}" for s in range(4) for i in range(4)]


def preemption_script():
    """Run (f)'s two waves of (name, labels, pool) and its gangs (name ->
    (kind, size)). Wave 1 (priority 1) fills both pools exactly; wave 2
    needs 40 of the 64 v5e hosts whole and 2 of the 4 slices."""
    wave1 = [(f"inf-e{i:03d}", {"tpu/chips": "2", "tpu/priority": "1"}, "mixed-e")
             for i in range(256)]
    wave1 += [(f"inf-p{i:02d}", {"tpu/chips": "4", "tpu/priority": "1"}, "mixed-p")
              for i in range(16)]
    gangs: dict[str, tuple[str, int]] = {}
    wave2 = []
    for g in range(2):
        gangs[f"train{g}"] = ("plain", 16)
        wave2 += [(f"train{g}-{m:02d}", {
            "tpu/gang": f"train{g}", "tpu/gang-size": "16", "tpu/chips": "8",
            "tpu/priority": "100"}, "mixed-e") for m in range(16)]
    wave2 += [(f"solo{i}", {"tpu/chips": "8", "tpu/priority": "50"}, "mixed-e")
              for i in range(8)]
    for g in range(2):
        gangs[f"topo{g}"] = ("topology", 4)
        wave2 += [(f"topo{g}-{m}", {
            "tpu/gang": f"topo{g}", "tpu/topology": "2x2x1", "tpu/chips": "4",
            "tpu/priority": "100"}, "mixed-p") for m in range(4)]
    return [wave1, wave2], gangs


def run_preemption(platform: str) -> dict:
    """Run (f) on one kernel_platform: wave 1, the agent republishing every
    bound host (their usage becomes metrics-visible: delta syncs), then
    wave 2, timed. Bindings (evictions included), counters and wave 2's
    latencies."""
    from yoda_tpu_torch.api.types import PodSpec
    from yoda_tpu_torch.ops import cuda_kernel
    from yoda_tpu_torch.ops import kernel as kernel_mod

    pools = {h: "mixed-e" for h in MIXED_E} | {h: "mixed-p" for h in MIXED_P}
    stack, agent = build_fleet(platform, 16, pools=pools)
    waves, gangs = preemption_script()
    plugin = stack.preemption
    post_filter_ms: list[float] = []
    fleet_calls: list[int] = []
    inner_post_filter, real_fleet_eval = plugin.post_filter, cuda_kernel.fleet_eval

    def timed_post_filter(*args, **kw):
        t = time.perf_counter()
        try:
            return inner_post_filter(*args, **kw)
        finally:
            post_filter_ms.append(1e3 * (time.perf_counter() - t))

    def counted_fleet_eval(*args, **kw):
        fleet_calls.append(args[4].shape[0])
        return real_fleet_eval(*args, **kw)

    plugin.post_filter = timed_post_filter
    cuda_kernel.fleet_eval = counted_fleet_eval
    cuda_kernel.launches = cuda_kernel.joint_fit_launches = 0
    kernel_mod.row_update_launches = 0
    try:
        for name, labels, pool in waves[0]:
            stack.cluster.create_pod(
                PodSpec(name, labels=dict(labels), node_selector={"pool": pool})
            )
        stack.scheduler.run_until_idle(max_wall_s=300)
        for host in sorted({p.node_name for p in stack.cluster.list_pods() if p.node_name}):
            agent.refresh(host)
        first_wave2 = len(stack.scheduler.stats.results)
        t0 = time.monotonic()
        for name, labels, pool in waves[1]:
            stack.cluster.create_pod(
                PodSpec(name, labels=dict(labels), node_selector={"pool": pool})
            )
        stack.scheduler.run_until_idle(max_wall_s=300)
        if platform != "cpu":
            torch.cuda.synchronize()
        wall = time.monotonic() - t0
    finally:
        cuda_kernel.fleet_eval = real_fleet_eval
    pods = [name for wave in waves for name, _, _ in wave]
    bound = bindings_of(stack, pods)
    wave2 = {name: labels for name, labels, _ in waves[1]}
    lat, completion = bind_latencies(
        stack.scheduler.stats.results[first_wave2:], wave2, bound
    )
    capacity = {
        t.name: sum(c.healthy for c in t.chips) for t in stack.cluster.list_tpu_metrics()
    }
    slice_of = {t.name: t.slice_id for t in stack.cluster.list_tpu_metrics()}
    verdicts = {}
    for g, (kind, size) in gangs.items():
        nodes = [bound[n] for n in pods if n.startswith(f"{g}-")]
        placed = [x for x in nodes if x not in (None, "evicted")]
        verdicts[g] = dict(kind=kind, size=size, bound=len(placed), hosts=len(set(placed)),
                           slices=len({slice_of[x] for x in placed}))
    b, r = stack.batch, stack.batch._resident
    return dict(
        platform=platform, pods=len(pods), bindings=bound, verdicts=verdicts,
        wave2_bound=sum(bound[n] not in (None, "evicted") for n in wave2),
        evicted=sorted(n for n, v in bound.items() if v == "evicted"),
        preempted_total=plugin.preempted_total,
        nominations=stack.scheduler.stats.preempt_nominations,
        nominated={p.name: p.nominated_node_name for p in stack.cluster.list_pods()
                   if p.nominated_node_name},
        overcommitted=[h for h, c in capacity.items() if stack.accountant.chips_in_use(h) > c],
        waiting=len(stack.framework.waiting_pods()),
        launches=cuda_kernel.launches, fleet_calls=len(fleet_calls),
        chunks=sum(-(-k // cuda_kernel.MAX_REQUESTS) for k in fleet_calls),
        joint_fit_launches=cuda_kernel.joint_fit_launches,
        row_update_launches=kernel_mod.row_update_launches,
        **{c: getattr(b, c) for c in GANG_COUNTERS},
        restacks=b.restacks, delta_syncs=r.delta_syncs, rows_applied=r.rows_applied,
        post_filter_calls=len(post_filter_ms),
        post_filter_ms_median=statistics.median(post_filter_ms) if post_filter_ms else None,
        post_filter_ms_max=max(post_filter_ms, default=None),
        wall_s=wall, pods_per_s=len(lat) / wall if wall else 0.0,
        p50_ms=pct_ms(lat, 0.5), p99_ms=pct_ms(lat, 0.99),
        gang_p50_ms=pct_ms(completion, 0.5), gang_p99_ms=pct_ms(completion, 0.99),
    )


PREEMPTION_PARITY = (
    "bindings", "evicted", "preempted_total", "nominations", "nominated", "restacks",
    "delta_syncs", "rows_applied", "dispatch_count", "joint_parked",
)


def check_preemption(g: dict, c: dict) -> None:
    diff = {k: (g[k], c[k]) for k in PREEMPTION_PARITY if g[k] != c[k]}
    if diff:
        short = {k: v if k != "bindings" else "differ" for k, v in diff.items()}
        raise AssertionError(f"run f: cuda != cpu in {short}")
    for run in (g, c):
        name = f"run f ({run['platform']})"
        if run["overcommitted"]:
            raise AssertionError(f"{name}: over-committed {run['overcommitted']}")
        if run["waiting"] or demoted(run):
            raise AssertionError(f"{name}: {run['waiting']} left at Permit, "
                                 f"{demoted(run)}")
        if run["wave2_bound"] != 48:
            raise AssertionError(f"{name}: {run['wave2_bound']}/48 wave-2 pods bound")
        if run["preempted_total"] != len(run["evicted"]) or not run["evicted"]:
            raise AssertionError(
                f"{name}: {run['preempted_total']} evictions counted, "
                f"{len(run['evicted'])} pods gone"
            )
        if any(not n.startswith("inf-") for n in run["evicted"]):
            raise AssertionError(f"{name}: a wave-2 pod was evicted: {run['evicted']}")
        if not run["nominations"] or run["restacks"] != 1 or not run["delta_syncs"]:
            raise AssertionError(
                f"{name}: nominations {run['nominations']}, restacks "
                f"{run['restacks']}, delta syncs {run['delta_syncs']} (want > 0, 1, > 0)"
            )
        for gang, v in run["verdicts"].items():
            if v["bound"] != v["size"] or (
                v["kind"] == "topology" and (v["hosts"] != 4 or v["slices"] != 1)
            ):
                raise AssertionError(f"{name}: gang {gang} not placed whole: {v}")
    if not 0 < g["launches"] == g["chunks"] or g["fleet_calls"] != g["dispatch_count"]:
        raise AssertionError(
            f"run f: {g['launches']} fleet_eval launches for {g['chunks']} chunks "
            f"of {g['fleet_calls']} calls, {g['dispatch_count']} dispatches"
        )
    if g["joint_fit_launches"] != g["fused_plan_dispatches"]:
        raise AssertionError(
            f"run f: {g['joint_fit_launches']} joint_fit launches for "
            f"{g['fused_plan_dispatches']} fused dispatches"
        )
    if g["row_update_launches"] != g["delta_syncs"]:
        raise AssertionError(
            f"run f: {g['row_update_launches']} row updates for {g['delta_syncs']} delta syncs"
        )
    if c["launches"] or c["joint_fit_launches"] or c["row_update_launches"]:
        raise AssertionError("run f: the CPU run launched on the card")


def phase_preemption(smi: str) -> dict:
    g = run_preemption("auto")
    c = run_preemption("cpu")
    for run in (g, c):
        summary = {k: v for k, v in run.items()
                   if k not in ("bindings", "evicted", "nominated", "verdicts")}
        summary["evicted"] = len(run["evicted"])
        print(f"preemption (f) {run['platform']} [{smi}]:", json.dumps(summary))
    check_preemption(g, c)
    return g


# Run (g): inter-pod affinity, topology spread, volumes and budgets on the
# 5,000-node fleet. Four zones: each v5p slice lies wholly in one (128
# slices a zone), the v5e hosts in four contiguous blocks of 738. The
# smaller size is the card tests' copy of the same script.
HOST_KEY = "kubernetes.io/hostname"
ZONE_KEY = "topology.kubernetes.io/zone"
ACCEL_KEY = "cloud.google.com/gke-tpu-accelerator"
V5E_ACCEL = "tpu-v5-lite-podslice"
CSI_DRIVER = "pd.csi.storage.gke.io"
AFFINITY_FULL = dict(slices=512, v5e_hosts=2952, replicas=48, kv=48, plain=64,
                     ft_a=8, ft_b=8, team_b=4, zonal=16, wffc=4, rwo=4, pool=32)
AFFINITY_SMALL = dict(slices=16, v5e_hosts=96, replicas=12, kv=12, plain=16,
                      ft_a=4, ft_b=4, team_b=4, zonal=8, wffc=4, rwo=4, pool=8)


def affinity_layout(size: dict) -> dict:
    """Run (g)'s fleet layout: each host's zone, the mixed-g pool (every
    other pool host's fill pod is budget-protected), the two local-SSD
    hosts of zone 2 with an attach limit of 1, the WaitForFirstConsumer
    claims' selected nodes and the ReadWriteOnce claim's host."""
    slices, v5e = size["slices"], size["v5e_hosts"]
    block = v5e // 4
    zone = {f"v5p-{s:03d}-{i}": s * 4 // slices for s in range(slices) for i in range(4)}
    zone |= {f"v5e-{h:04d}": min(h // block, 3) for h in range(v5e)}
    pool = [f"v5e-{i * v5e // size['pool'] + 7:04d}" for i in range(size["pool"])]
    return dict(
        zone=zone, pool=pool,
        ssd=[f"v5e-{2 * block + 5:04d}", f"v5e-{2 * block + 11:04d}"],
        wffc=[f"v5e-{(i % 4) * block + block // 2 + i:04d}" for i in range(size["wffc"])],
        rwo_host=f"v5e-{block + 30:04d}",
    )


def affinity_script(size: dict):
    """Run (g)'s objects: (Node objects by host, Namespaces, claims and
    volumes, the bound ReadWriteOnce holder, wave 1's pods, wave 2's fill,
    the budget, the preempting gang and the singleton). Everything in the
    port's own types."""
    from yoda_tpu_torch.api.affinity import (
        LabelSelector,
        PodAffinityTerm,
        TopologySpreadConstraint,
    )
    from yoda_tpu_torch.api.types import (
        K8sNamespace,
        K8sNode,
        K8sPdb,
        K8sPv,
        K8sPvc,
        NodeSelectorRequirement,
        NodeSelectorTerm,
        PodSpec,
        Taint,
        Toleration,
    )

    lay = affinity_layout(size)
    pool, ssd = set(lay["pool"]), set(lay["ssd"])

    def node(name: str):
        labels = {HOST_KEY: name, ZONE_KEY: f"zone-{lay['zone'][name]}",
                  ACCEL_KEY: "tpu-v5p-slice" if name.startswith("v5p") else V5E_ACCEL}
        taints, attach = [], {}
        if name in pool:
            labels["pool"] = "mixed-g"
            taints = [Taint("dedicated", "mixed-g", "NoSchedule")]
        if name in ssd:
            labels["storage"] = "local-ssd"
            attach = {f"csi-{CSI_DRIVER}": 1}
        return K8sNode(name, labels=labels, taints=taints, attach_limits=attach)

    def sel(**labels):
        return LabelSelector(match_labels=tuple(sorted(labels.items())))

    def zone_term(z: str):
        return NodeSelectorTerm(match_expressions=(NodeSelectorRequirement(ZONE_KEY, "In", (z,)),))

    v5e = {ACCEL_KEY: V5E_ACCEL}
    namespaces = [K8sNamespace("default", {"tier": "serving"}),
                  K8sNamespace("team-b", {"tier": "research"})]
    # Wave 1 in creation (and so queue) order: the volume pods, then the
    # plain singletons (bursts, while no bound pod declares terms), then
    # the serving replicas, their caches, team-b's pods and the two gangs.
    volumes, vol_pods, wave1 = [], [], []
    for name, labels in fleet_and_pods(seed=3)[0][: size["plain"]]:
        wave1.append(PodSpec(f"g-{name}", labels=dict(labels)))
    serve = sel(app="llm-serve")
    for i in range(size["replicas"]):
        wave1.append(PodSpec(
            f"llm-serve-{i:02d}", node_selector=dict(v5e),
            labels={"app": "llm-serve", "pod-template-hash": "5d8c7b9f4", "tpu/chips": "4"},
            pod_anti_affinity=(PodAffinityTerm(HOST_KEY, serve),),
            topology_spread=(TopologySpreadConstraint(
                1, ZONE_KEY, "DoNotSchedule", serve, ("pod-template-hash",)),),
        ))
    for i in range(size["kv"]):
        wave1.append(PodSpec(
            f"kv-cache-{i:02d}", node_selector=dict(v5e),
            labels={"app": "kv-cache", "tpu/chips": "2"},
            preferred_pod_affinity=((100, PodAffinityTerm(HOST_KEY, serve)),),
        ))
    for i in range(size["team_b"]):
        wave1.append(PodSpec(
            f"eval-{i}", namespace="team-b", labels={"app": "eval", "tpu/chips": "2"},
            pod_affinity=(PodAffinityTerm(
                ZONE_KEY, serve, namespace_selector=sel(tier="serving")),),
        ))
    for gang, n, chips, term in (
        ("ft-a", size["ft_a"], "4", "anti"), ("ft-b", size["ft_b"], "8", "aff"),
    ):
        own = PodAffinityTerm(HOST_KEY if term == "anti" else ZONE_KEY, sel(app=gang))
        for m in range(n):
            wave1.append(PodSpec(
                f"{gang}-{m}",
                labels={"app": gang, "tpu/gang": gang, "tpu/gang-size": str(n),
                        "tpu/chips": chips},
                pod_anti_affinity=(own,) if term == "anti" else (),
                pod_affinity=(own,) if term == "aff" else (),
            ))
    for i in range(size["zonal"]):
        z = f"zone-{i % 4}"
        volumes += [
            K8sPv(f"pv-zonal-{i}", node_affinity=(zone_term(z),),
                  claim_ref=f"default/zonal-{i}", driver=CSI_DRIVER),
            K8sPvc(f"zonal-{i}", zone=z, access_modes=("ReadWriteOnce",),
                   volume_name=f"pv-zonal-{i}"),
        ]
        prefer_ssd = ()
        if z == "zone-2":
            prefer_ssd = ((100, NodeSelectorTerm(match_expressions=(
                NodeSelectorRequirement("storage", "In", ("local-ssd",)),))),)
        vol_pods.append(PodSpec(f"vol-zonal-{i:02d}", labels={"tpu/chips": "1"},
                                pvc_names=(f"zonal-{i}",),
                                preferred_node_affinity=prefer_ssd))
    for i, host in enumerate(lay["wffc"]):
        volumes.append(K8sPvc(f"wffc-{i}", selected_node=host,
                              access_modes=("ReadWriteOnce",)))
        vol_pods.append(PodSpec(f"vol-wffc-{i}", labels={"tpu/chips": "2"},
                                pvc_names=(f"wffc-{i}",)))
    volumes.append(K8sPvc("shared-rwo", access_modes=("ReadWriteOnce",)))
    holder = PodSpec("rwo-holder", labels={"tpu/chips": "1"}, pvc_names=("shared-rwo",),
                     node_name=lay["rwo_host"], phase="Running")
    for i in range(size["rwo"]):
        vol_pods.append(PodSpec(f"vol-rwo-{i}", labels={"tpu/chips": "1"},
                                pvc_names=("shared-rwo",)))
    wave1 = vol_pods + wave1
    tolerate = [Toleration("dedicated", "Equal", "mixed-g", "NoSchedule")]
    on_pool = {"pool": "mixed-g"}
    fill = [
        PodSpec(f"fill-{i:02d}", node_selector=dict(on_pool), tolerations=list(tolerate),
                labels={"app": "batch-protected" if i % 2 == 0 else "batch",
                        "tpu/chips": "8", "tpu/priority": "1"})
        for i in range(size["pool"])
    ]
    budget = K8sPdb("batch-protected", selector=sel(app="batch-protected"),
                    disruptions_allowed=0)
    half = size["pool"] // 2
    gang = [
        PodSpec(f"ft-pre-{m:02d}", node_selector=dict(on_pool), tolerations=list(tolerate),
                labels={"tpu/gang": "ft-pre", "tpu/gang-size": str(half),
                        "tpu/chips": "8", "tpu/priority": "100"})
        for m in range(half)
    ]
    solo = PodSpec("solo-50", node_selector=dict(on_pool), tolerations=list(tolerate),
                   labels={"tpu/chips": "8", "tpu/priority": "50"})
    return dict(node=node, namespaces=namespaces, volumes=volumes, holder=holder,
                wave1=wave1, fill=fill, budget=budget, gang=gang, solo=solo, layout=lay)


def run_affinity(platform: str, size: dict = AFFINITY_FULL) -> dict:
    """Run (g) on one kernel_platform: Namespaces, claims, volumes and the
    bound ReadWriteOnce holder, then wave 1 at batch_requests 16 (timed),
    then wave 2 (timed): the pool's fill and its budget, the agent
    republishing every bound host, the priority-100 gang and the
    priority-50 singleton. Bindings, evictions, counters and the host and
    device times the run's affinity pods cost."""
    from yoda_tpu_torch.api import affinity as aff_mod
    from yoda_tpu_torch.ops import cuda_kernel
    from yoda_tpu_torch.ops import kernel as kernel_mod
    from yoda_tpu_torch.plugins.yoda import batch as batch_mod

    script = affinity_script(size)
    stack, agent = build_fleet(platform, 16, node_fn=script["node"], slices=size["slices"],
                               v5e_hosts=size["v5e_hosts"])
    cluster, plugin, b = stack.cluster, stack.preemption, stack.batch
    for ns in script["namespaces"]:
        cluster.put_namespace(ns)
    for obj in script["volumes"]:
        (cluster.put_pv if hasattr(obj, "driver") else cluster.put_pvc)(obj)
    cluster.create_pod(script["holder"])

    times: dict[str, list[float]] = {"evaluators": [], "admission": [], "bonus": [],
                                     "post_filter": []}
    fleet_calls: list[int] = []
    refused: list[str] = []
    k1_args: list = []

    def timed(key, fn, when=lambda *a, **kw: True):
        def wrapper(*args, **kw):
            t = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                if when(*args, **kw):
                    times[key].append(1e3 * (time.perf_counter() - t))
        return wrapper

    def counted_fleet_eval(*args, **kw):
        fleet_calls.append(args[4].shape[0])
        if args[4].shape[0] == 1 and platform != "cpu":
            k1_args[:] = [a.clone() for a in args[:5]] + [args[5]]
        return real_fleet_eval(*args, **kw)

    def counted_evict(key):
        ok = real_evict(key)
        if ok is False:
            refused.append(key)
        return ok

    builds = {cls: cls.__dict__["build"] for cls in (aff_mod.InterPodEvaluator,
                                                     aff_mod.SpreadEvaluator)}
    real_fleet_eval, real_admission = cuda_kernel.fleet_eval, batch_mod._host_admission
    real_evict = plugin.evict_fn
    for cls, build in builds.items():
        setattr(cls, "build", timed("evaluators", build.__get__(None, cls)))
    batch_mod._host_admission = timed(
        "admission", real_admission, lambda *a, **kw: len(a) > 3 and a[3] is not None)
    b._preference_bonus = timed(
        "bonus", b._preference_bonus, lambda *a, **kw: len(a) > 3 and a[3] is not None)
    plugin.post_filter = timed("post_filter", plugin.post_filter)
    plugin.evict_fn = counted_evict
    cuda_kernel.fleet_eval = counted_fleet_eval
    cuda_kernel.launches = cuda_kernel.joint_fit_launches = 0
    kernel_mod.row_update_launches = 0
    walls = []
    try:
        t0 = time.monotonic()
        for pod in script["wave1"]:
            cluster.create_pod(pod)
        stack.scheduler.run_until_idle(max_wall_s=600)
        walls.append(time.monotonic() - t0)
        first_wave2 = len(stack.scheduler.stats.results)
        t0 = time.monotonic()
        cluster.put_pdb(script["budget"])
        for pod in script["fill"]:
            cluster.create_pod(pod)
        stack.scheduler.run_until_idle(max_wall_s=300)
        for host in sorted({p.node_name for p in cluster.list_pods() if p.node_name}):
            agent.refresh(host)
        for pod in script["gang"]:
            cluster.create_pod(pod)
        stack.scheduler.run_until_idle(max_wall_s=300)
        cluster.create_pod(script["solo"])
        stack.scheduler.run_until_idle(max_wall_s=300)
        if platform != "cpu":
            torch.cuda.synchronize()
        walls.append(time.monotonic() - t0)
    finally:
        cuda_kernel.fleet_eval = real_fleet_eval
        batch_mod._host_admission = real_admission
        for cls, build in builds.items():
            setattr(cls, "build", build)
    launches = cuda_kernel.launches
    device_k1, windows, k1_ms, k1_plain_ms = None, [], None, None
    if k1_args:
        # The tracer was seen to lose kernel records on this input (16 of
        # 20 in every window, while both counts said 20): the fullest short
        # window gives the time per recorded launch.
        device_k1, _per_call, windows = profiled_ms(
            lambda: cuda_kernel.fleet_eval(*k1_args), lambda: cuda_kernel.launches,
            short_ok=True)
        from yoda_tpu_torch.ops.kernel import kernel_packed_burst

        k1_ms = cuda_ms(lambda: cuda_kernel.fleet_eval(*k1_args))
        cpu_args = [a.cpu() if torch.is_tensor(a) else a for a in k1_args]
        k1_plain_ms = cuda_ms(lambda: kernel_packed_burst(*cpu_args), warmup=1, iters=3)
    waves = {"wave1": script["wave1"],
             "wave2": script["fill"] + script["gang"] + [script["solo"]]}
    pods = [script["holder"]] + waves["wave1"] + waves["wave2"]
    bound = {}
    for p in pods:
        live = cluster.get_pod(p.key)
        bound[p.name] = "evicted" if live is None else live.node_name
    results = stack.scheduler.stats.results
    lat = {}
    for wave, start, end in (("wave1", 0, first_wave2), ("wave2", first_wave2, None)):
        labels_of = {p.name: p.labels for p in waves[wave]}
        lat[wave] = bind_latencies(results[start:end], labels_of, bound)
    capacity = {t.name: sum(c.healthy for c in t.chips) for t in cluster.list_tpu_metrics()}
    snap = stack.informer.snapshot()
    r = b._resident

    def ms(key):
        xs = times[key]
        return dict(calls=len(xs), median=statistics.median(xs) if xs else None,
                    max=max(xs, default=None))

    out = dict(
        platform=platform, nodes=len(snap), bindings=bound,
        evicted=sorted(n for n, v in bound.items() if v == "evicted"),
        preempted_total=plugin.preempted_total, refused_evictions=len(refused),
        nominations=stack.scheduler.stats.preempt_nominations,
        nominated={p.name: p.nominated_node_name for p in cluster.list_pods()
                   if p.nominated_node_name},
        overcommitted=[h for h, c in capacity.items() if stack.accountant.chips_in_use(h) > c],
        waiting=len(stack.framework.waiting_pods()),
        launches=launches, fleet_calls=len(fleet_calls),
        fleet_calls_k1=sum(k == 1 for k in fleet_calls),
        chunks=sum(-(-k // cuda_kernel.MAX_REQUESTS) for k in fleet_calls),
        joint_fit_launches=cuda_kernel.joint_fit_launches,
        row_update_launches=kernel_mod.row_update_launches,
        **{c: getattr(b, c) for c in GANG_COUNTERS},
        restacks=b.restacks, delta_syncs=r.delta_syncs, rows_applied=r.rows_applied,
        admission_reuse=b.admission_reuse, admission_rebuilds=b.admission_rebuilds,
        evaluator_build_ms=ms("evaluators"), admission_row_with_aff_ms=ms("admission"),
        preference_bonus_ms=ms("bonus"), post_filter_ms=ms("post_filter"),
        fleet_eval_k1_device_ms=device_k1, fleet_eval_k1_profiler_windows=windows,
        fleet_eval_k1_ms=k1_ms, fleet_eval_k1_plain_ms=k1_plain_ms,
        not_built=list(stack.not_built),
    )
    for wave, wall in zip(("wave1", "wave2"), walls):
        per_pod, gangs = lat[wave]
        out[wave] = dict(wall_s=wall, pods=len(waves[wave]),
                         pods_per_s=len(per_pod) / wall if wall else 0.0,
                         p50_ms=pct_ms(per_pod, 0.5), p99_ms=pct_ms(per_pod, 0.99),
                         gang_p50_ms=pct_ms(gangs, 0.5), gang_p99_ms=pct_ms(gangs, 0.99))
    out["checks"] = affinity_checks(stack, snap, script, bound)
    return out


def affinity_checks(stack, snap, script, bound) -> dict:
    """Run (g)'s placement facts, read off one run's final state."""
    from yoda_tpu_torch.plugins.yoda.filter_plugin import (
        node_fits_attach_limits,
        node_fits_volumes,
        resolve_volumes,
    )

    lay = script["layout"]
    zone_of = {h: f"zone-{z}" for h, z in lay["zone"].items()}

    def placed(prefix):
        return [v for n, v in bound.items() if n.startswith(prefix)]

    serve = placed("llm-serve-")
    per_zone = [sum(zone_of.get(h) == f"zone-{z}" for h in serve) for z in range(4)]
    kv_with_serve = sum(h in set(serve) for h in placed("kv-cache-"))
    volume_misplaced, attach_over = [], []
    for ni in snap.infos():
        for p in ni.pods:
            if p.pvc_names and p.name != "rwo-holder":
                claims, missing = resolve_volumes(snap, p)
                # A pod's own ReadWriteOnce claim pins it to where it (and
                # its co-users) mount it: checked below by name.
                claims = [c for c in claims if c.allowed_nodes is None]
                if missing is not None or not node_fits_volumes(claims, ni)[0]:
                    volume_misplaced.append(p.name)
        if not node_fits_attach_limits((), ni, snap.pvcs or {}, snap.pvs or {})[0]:
            attach_over.append(ni.name)
    if any(h != lay["rwo_host"] for h in placed("vol-rwo-")):
        volume_misplaced.append("vol-rwo")
    if any(bound[f"vol-wffc-{i}"] != h for i, h in enumerate(lay["wffc"])):
        volume_misplaced.append("vol-wffc")
    wave1 = [p.name for p in script["wave1"]]
    eval_zones = {zone_of.get(h) for h in placed("eval-")}
    return dict(
        wave1_unbound=[n for n in wave1 if bound[n] in (None, "evicted")],
        serve_hosts_distinct=len(set(serve)) == len(serve),
        serve_per_zone=per_zone, serve_skew=max(per_zone) - min(per_zone),
        kv_cache_beside_serve=kv_with_serve,
        eval_in_serve_zones=eval_zones <= {zone_of.get(h) for h in serve},
        ft_a_hosts=len(set(placed("ft-a-"))), ft_b_zones=len({zone_of.get(h) for h in placed("ft-b-")}),
        ssd_hosts_used=sorted(set(placed("vol-zonal-")) & set(lay["ssd"])),
        volume_misplaced=volume_misplaced, attach_over=attach_over,
        protected_evicted=[n for n in bound if bound[n] == "evicted"
                           and n.startswith("fill-") and int(n[5:]) % 2 == 0],
        gang_bound=sum(h not in (None, "evicted") for h in placed("ft-pre-")),
        gang_on_pool=all(h in set(lay["pool"]) for h in placed("ft-pre-")),
        solo=bound["solo-50"],
    )


AFFINITY_PARITY = (
    "bindings", "evicted", "preempted_total", "refused_evictions", "nominations",
    "nominated", "dispatch_count", "burst_dispatches", "burst_served", "restacks",
    "delta_syncs", "rows_applied", "joint_parked", "checks",
)


def check_affinity_run(run: dict, size: dict) -> None:
    """Run (g)'s invariants on one platform's run."""
    name, c = f"run g ({run['platform']})", run["checks"]
    want_gang = size["pool"] // 2
    failures = []
    if run["overcommitted"]:
        failures.append(f"over-committed {run['overcommitted']}")
    if run["waiting"] or demoted(run):
        failures.append(f"{run['waiting']} left at Permit, {demoted(run)}")
    if c["wave1_unbound"]:
        failures.append(f"wave 1 left unbound: {c['wave1_unbound']}")
    if not c["serve_hosts_distinct"] or c["serve_skew"] > 1:
        failures.append(f"llm-serve replicas share a host or skew: {c['serve_per_zone']}")
    if not c["eval_in_serve_zones"]:
        failures.append("a team-b pod sits in a zone without an llm-serve replica")
    if c["ft_a_hosts"] != size["ft_a"] or c["ft_b_zones"] != 1:
        failures.append(f"ft-a on {c['ft_a_hosts']} hosts, ft-b in {c['ft_b_zones']} zones")
    if c["volume_misplaced"] or c["attach_over"]:
        failures.append(f"volumes misplaced {c['volume_misplaced']}, "
                        f"attach limits exceeded on {c['attach_over']}")
    if c["protected_evicted"]:
        failures.append(f"budget-protected pods evicted: {c['protected_evicted']}")
    if c["gang_bound"] != want_gang or not c["gang_on_pool"]:
        failures.append(f"preempting gang: {c['gang_bound']}/{want_gang} bound")
    if run["preempted_total"] != want_gang or len(run["evicted"]) != want_gang:
        failures.append(f"{run['preempted_total']} evictions, {len(run['evicted'])} pods gone "
                        f"(want {want_gang})")
    if c["solo"] is not None or not run["refused_evictions"]:
        failures.append(f"solo-50 on {c['solo']}, {run['refused_evictions']} refused evictions")
    if failures:
        raise AssertionError(f"{name}: " + "; ".join(failures))


def check_affinity(g: dict, c: dict, size: dict) -> None:
    diff = {k: (g[k], c[k]) for k in AFFINITY_PARITY if g[k] != c[k]}
    if diff:
        short = {k: v if k != "bindings" else "differ" for k, v in diff.items()}
        raise AssertionError(f"run g: cuda != cpu in {short}")
    for run in (g, c):
        check_affinity_run(run, size)
    if not 0 < g["launches"] == g["chunks"] or g["fleet_calls"] != g["dispatch_count"]:
        raise AssertionError(
            f"run g: {g['launches']} fleet_eval launches for {g['chunks']} chunks "
            f"of {g['fleet_calls']} calls, {g['dispatch_count']} dispatches"
        )
    if g["joint_fit_launches"] != g["fused_plan_dispatches"]:
        raise AssertionError(
            f"run g: {g['joint_fit_launches']} joint_fit launches for "
            f"{g['fused_plan_dispatches']} fused dispatches"
        )
    if g["row_update_launches"] != g["delta_syncs"]:
        raise AssertionError(
            f"run g: {g['row_update_launches']} row updates for {g['delta_syncs']} delta syncs"
        )
    if c["launches"] or c["joint_fit_launches"] or c["row_update_launches"]:
        raise AssertionError("run g: the CPU run launched on the card")


def phase_affinity(smi: str) -> dict:
    g = run_affinity("auto")
    c = run_affinity("cpu")
    for run in (g, c):
        summary = {k: v for k, v in run.items()
                   if k not in ("bindings", "evicted", "nominated")}
        summary["evicted"] = len(run["evicted"])
        print(f"affinity (g) {run['platform']} [{smi}]:", json.dumps(summary))
    check_affinity(g, c, AFFINITY_FULL)
    return g


def wide_fleet_script(seed: int = 5):
    """A fleet of 16 hosts of 40 chips (the lowering pads every node to 64)
    and 48 of 8, and 96 singletons of 1-32 chips, some with HBM or clock
    floors."""
    rng = np.random.default_rng(seed)
    hosts = [(f"big-{h:02d}", 40) for h in range(16)] + [(f"v5e-{h:02d}", 8) for h in range(48)]
    pods = []
    for i in range(96):
        labels = {"tpu/chips": str(int(rng.choice([1, 2, 4, 8, 16, 32])))}
        if rng.random() < 0.5:
            labels["tpu/hbm"] = f"{int(rng.integers(1, 16))}Gi"
        if rng.random() < 0.2:
            labels["tpu/clock"] = "900"
        pods.append((f"w{i:02d}", labels))
    return hosts, pods


def run_wide_fleet(platform: str, burst: int) -> dict:
    """The wide fleet's singletons through build_stack on one platform:
    bindings, launches and dispatches."""
    from yoda_tpu_torch.agent.fake_publisher import FakeTpuAgent
    from yoda_tpu_torch.api.types import PodSpec
    from yoda_tpu_torch.config import SchedulerConfig
    from yoda_tpu_torch.ops import cuda_kernel
    from yoda_tpu_torch.standalone import build_stack

    stack = build_stack(
        config=SchedulerConfig(kernel_platform=platform, batch_requests=burst)
    )
    agent = FakeTpuAgent(stack.cluster)
    hosts, pods = wide_fleet_script()
    for name, chips in hosts:
        agent.add_host(name, generation="v5e", chips=chips)
    agent.publish_all()
    for name, labels in pods:
        stack.cluster.create_pod(PodSpec(name, labels=dict(labels)))
    cuda_kernel.launches = 0
    stack.scheduler.run_until_idle(max_wall_s=120)
    if platform != "cpu":
        torch.cuda.synchronize()
    b = stack.batch
    return dict(
        platform=platform, burst=burst, chip_bucket=int(b._static.hbm_free_mib.shape[1]),
        bindings=bindings_of(stack, [n for n, _ in pods]),
        launches=cuda_kernel.launches, dispatch_count=b.dispatch_count,
        **dispatch_health(b),
    )


def phase_wide_fleet(smi: str) -> list[dict]:
    """The 40-chip stack check: bindings on the card equal the CPU run's,
    every evaluation launched the wide kernel."""
    out = []
    for burst in (1, 16):
        g, c = run_wide_fleet("auto", burst), run_wide_fleet("cpu", burst)
        bound = sum(v is not None for v in g["bindings"].values())
        print(f"wide fleet (40 + 8 chips, K = {burst}) [{smi}]:", json.dumps(
            {k: v for k, v in g.items() if k != "bindings"} | {"bound": bound}))
        if g["bindings"] != c["bindings"]:
            diff = [p for p in g["bindings"] if g["bindings"][p] != c["bindings"][p]]
            raise AssertionError(f"wide fleet: {len(diff)} pods bound differently, e.g. {diff[:3]}")
        if g["chip_bucket"] != 64 or not 0 < bound < len(g["bindings"]):
            raise AssertionError(f"wide fleet: bucket {g['chip_bucket']}, {bound} bound")
        if demoted(g) or not 0 < g["launches"] == g["dispatch_count"]:
            raise AssertionError(
                f"wide fleet: {g['launches']} launches for {g['dispatch_count']} "
                f"dispatches, {demoted(g)}"
            )
        if c["launches"]:
            raise AssertionError("wide fleet: the CPU run launched the kernel")
        out.append(g)
    return out


# Run (h): the background path on the 5,000-node fleet — the speculative
# placement cache, the rebalancer, the reconciler, and all of them on a
# second thread while the serve loop runs. The smaller size is the tests'
# copy of the same script.
BACKGROUND_FULL = dict(slices=512, v5e_hosts=2952, waves=8, wave=16, pool=64,
                       frag_slices=4, gang=16, threaded_pods=256, threaded_s=8.0,
                       period_s=1.0)
BACKGROUND_SMALL = dict(slices=16, v5e_hosts=96, waves=4, wave=8, pool=24,
                        frag_slices=4, gang=4, threaded_pods=32, threaded_s=1.0,
                        period_s=0.1)
# (h1)'s four hot shapes: v5e pods of 1, 2, 4 and 8 chips.
HOT_SHAPES = (1, 2, 4, 8)


def hot_pod(name: str, chips: int):
    from yoda_tpu_torch.api.types import PodSpec

    return PodSpec(name, labels={"tpu/chips": str(chips), "tpu/generation": "v5e"})


def singleton_latencies(stack, names: "list[str]") -> list[float]:
    """Sorted seconds from each bound singleton's first cycle start to its
    bind (bind_latencies over pods without gang labels)."""
    labels = {n: stack.cluster.get_pod(f"default/{n}").labels for n in names}
    return bind_latencies(stack.scheduler.stats.results, labels,
                          bindings_of(stack, names))[0]


def over_capacity(stack) -> list[str]:
    capacity = {
        t.name: sum(c.healthy for c in t.chips) for t in stack.cluster.list_tpu_metrics()
    }
    return [h for h, c in capacity.items() if stack.accountant.chips_in_use(h) > c]


def accounting_gap(stack) -> dict:
    """Nodes whose reserved chips differ from the chips of their bound pods."""
    from yoda_tpu_torch.api.requests import pod_request

    bound: dict[str, int] = {}
    for p in stack.cluster.list_pods():
        if p.node_name:
            bound[p.node_name] = bound.get(p.node_name, 0) + pod_request(p).effective_chips
    held = {n: c for n, c in stack.accountant.chips_by_node().items() if c}
    return {n: (held.get(n, 0), bound.get(n, 0))
            for n in set(held) | set(bound) if held.get(n, 0) != bound.get(n, 0)}


def update_rows_device_ms(spec, rows: int = 64, calls: int = 20) -> dict:
    """The private mirror's ``update_rows`` on its own stream: device ms per
    call of ``rows`` rows (its index_copy_ pair; the pinned upload is a
    copy, counted apart) from a profiler window over ``calls`` calls, and
    the host's ms per call by CUDA events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    kern, arrays = spec.kernel, spec._fleet.arrays
    picked = list(range(0, min(rows * 37, len(arrays.names)), 37))[:rows]
    with torch.cuda.stream(spec._stream):
        kern.update_rows(arrays, picked)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                kern.update_rows(arrays, picked)
            torch.cuda.synchronize()
        host_ms = cuda_ms(lambda: kern.update_rows(arrays, picked))
    kernel_us = copy_us = 0.0
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:
            continue
        total = getattr(evt, "self_device_time_total", None)
        if total is None:
            total = evt.self_cuda_time_total
        if evt.key.startswith("Memcpy"):
            copy_us += total
        else:
            kernel_us += total
    if not kernel_us:
        return dict(rows=len(picked), device_ms=None, copy_ms=None, ms=host_ms)
    return dict(rows=len(picked), device_ms=kernel_us / calls / 1e3,
                copy_ms=copy_us / calls / 1e3, ms=host_ms)


def stream_kernels(prof, kernel: str) -> "dict[int, list[tuple[int, int]]]":
    """(start, end) ns of every device record of ``kernel`` in a profiler
    window, by the stream the tracer saw it on."""
    from torch.autograd import DeviceType

    out: dict[int, list[tuple[int, int]]] = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA and kernel in e.name():
            start = e.start_ns()
            out.setdefault(e.device_resource_id(), []).append((start, start + e.duration_ns()))
    return out


def concurrent_eval(stack, spec, spec_inputs, calls: int = 40) -> dict:
    """fleet_eval at K = 1 on the speculation cache's stream, alone and while
    a second thread launches, in a loop on the default stream, what the
    serve path launches: fleet_eval at K = 16 and joint_fit on run (c)'s
    seeded 64 x 8,192 rows (JOINT_MAIN_SHAPE, one cluster of up to 16
    blocks). CUDA-event ms per call on the private stream (from the host's
    enqueue to the kernel's end: a wait for the card's SMs, or for the
    interpreter lock the other thread holds, shows there); from a profiler
    window of each, the private kernel's own device ms and how many of its
    launches overlapped a serve-stream fleet_eval or joint_fit in time; and
    every result of both threads held against the plain version of the
    same inputs."""
    import threading

    from torch.profiler import ProfilerActivity, profile

    from yoda_tpu_torch.ops.cuda_kernel import fleet_eval, joint_fit
    from yoda_tpu_torch.ops.kernel import joint_fit_scan, kernel_packed_burst, pack_request

    kern = spec.kernel
    dyn, request = spec_inputs
    dev = kern.device
    d_dyn = torch.from_numpy(np.ascontiguousarray(dyn)).to(dev)
    spec_args = (kern._chips, kern._nodes, d_dyn, d_dyn[3:4].contiguous(),
                 torch.from_numpy(pack_request(request)[None]).to(dev), kern.weights)
    serve = stack.batch._kern
    rng = np.random.default_rng(7)
    n = serve._chips.shape[2]
    host_ok = (rng.random((16, n)) < 0.5).astype(np.int32)
    reqs = REQUEST_TABLE[rng.integers(0, len(REQUEST_TABLE), 16)]
    serve_dyn = np.ascontiguousarray(dyn)
    serve_args = (serve._chips, serve._nodes, torch.from_numpy(serve_dyn).to(dev),
                  torch.from_numpy(host_ok).to(dev), torch.from_numpy(reqs).to(dev),
                  serve.weights)
    k, jn = JOINT_MAIN_SHAPE
    joint_args = tuple(torch.from_numpy(x).to(dev)
                       for x in joint_case(k, jn, seed=k * 7 + jn))
    plain = [kernel_packed_burst(*(t.cpu() if torch.is_tensor(t) else t for t in args))
             for args in (spec_args, serve_args)]
    cpu_spec_args = [t.cpu() if torch.is_tensor(t) else t for t in spec_args]
    plain_ms = cuda_ms(lambda: kernel_packed_burst(*cpu_spec_args), warmup=1, iters=3)
    packed_cpu = joint_args[0].cpu()
    plain_joint = [w.to(torch.int32) for w in joint_fit_scan(
        packed_cpu[:, 0], packed_cpu[:, 3], packed_cpu[:, 5],
        *(t.cpu() for t in joint_args[1:]))]
    bad: list[str] = []

    def timed(label: str) -> float:
        times = []
        with torch.cuda.stream(spec._stream):
            for _ in range(calls):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                out = fleet_eval(*spec_args)
                end.record()
                end.synchronize()
                times.append(start.elapsed_time(end))
                if not torch.equal(out.cpu(), plain[0]):
                    bad.append(label)
        return statistics.median(times)

    alone = timed("alone")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        timed("alone, profiled")
    alone_kernels = [iv for ivs in stream_kernels(prof, "fleet_eval").values() for iv in ivs]
    stop = threading.Event()
    serve_calls = [0]
    errors: list[BaseException] = []

    def serve_loop():
        try:
            while not stop.is_set():
                out = fleet_eval(*serve_args)
                got = joint_fit(*joint_args)
                torch.cuda.current_stream(dev).synchronize()
                if not torch.equal(out.cpu(), plain[1]):
                    bad.append("serve thread fleet_eval")
                if not all(torch.equal(g.cpu(), w) for g, w in zip(got, plain_joint)):
                    bad.append("serve thread joint_fit")
                serve_calls[0] += 1
        except BaseException as e:  # noqa: BLE001 — reported below
            errors.append(e)

    thread = threading.Thread(target=serve_loop, daemon=True)
    thread.start()
    try:
        time.sleep(0.05)
        before = serve_calls[0]
        concurrent = timed("concurrent")
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            timed("concurrent, profiled")
        during = serve_calls[0] - before
    finally:
        stop.set()
        thread.join(timeout=30)
    by_stream = stream_kernels(prof, "fleet_eval")
    joints = [iv for ivs in stream_kernels(prof, "joint_fit").values() for iv in ivs]
    if thread.is_alive() or errors or bad or not during:
        raise AssertionError(
            f"concurrent fleet_eval: alive {thread.is_alive()}, errors {errors}, "
            f"serve-thread passes during the windows {during}, results that "
            f"differ from the plain version: {sorted(set(bad))}"
        )
    # The private stream is the one whose kernels ran alone at K = 1: its
    # records are the shortest. The other stream's are the serve thread's.
    private = min(by_stream, default=None,
                  key=lambda s: statistics.mean(b - a for a, b in by_stream[s]))
    mine = by_stream.get(private, [])
    theirs = [iv for s, ivs in by_stream.items() if s != private for iv in ivs]

    def device_ms(ivs):
        return statistics.mean(b - a for a, b in ivs) / 1e6 if ivs else None

    def overlapping(others):
        return sum(any(a < d and c < b for c, d in others) for a, b in mine)

    return dict(
        alone_ms=alone, concurrent_ms=concurrent, calls=calls, plain_ms=plain_ms,
        serve_thread_calls=serve_calls[0], serve_thread_calls_in_windows=during,
        alone_device_ms=device_ms(alone_kernels), profiled_alone=len(alone_kernels),
        concurrent_device_ms=device_ms(mine),
        serve_device_ms=device_ms(theirs), joint_fit_device_ms=device_ms(joints),
        profiled_private=len(mine), profiled_serve=len(theirs),
        profiled_joint_fit=len(joints), streams=len(by_stream),
        overlapped=overlapping(theirs), overlapped_joint_fit=overlapping(joints),
    )


def run_speculation(platform: str, size: dict) -> dict:
    """(h1): hot-shape singletons at K = 1 in ``waves`` waves of ``wave``,
    one speculate_once before each; after each wave the agent republishes
    the hosts it bound (their usage becomes metrics-visible: both mirrors
    take delta syncs, the private one with update_rows on its stream).
    Bindings, every tick's plans, the cache's counters, times and the
    private kernel's launches."""
    from yoda_tpu_torch.ops import cuda_kernel
    from yoda_tpu_torch.ops import kernel as kernel_mod

    stack, agent = build_fleet(platform, 1, slices=size["slices"],
                               v5e_hosts=size["v5e_hosts"])
    spec = stack.speculation
    rng = np.random.default_rng(8)
    bind_ms: list[float] = []
    spec.bind_observe = bind_ms.append
    kept: list = []
    inner_evaluate = spec.kernel.evaluate

    def kept_evaluate(dyn, request):
        kept[:] = [(np.array(dyn), request)]
        return inner_evaluate(dyn, request)

    spec.kernel.evaluate = kept_evaluate
    cuda_kernel.launches = cuda_kernel.joint_fit_launches = 0
    kernel_mod.row_update_launches = 0
    tick_ms, plans, names = [], [], []
    t0 = time.monotonic()
    for w in range(size["waves"]):
        t = time.perf_counter()
        produced = spec.speculate_once()
        if platform != "cpu":
            torch.cuda.synchronize()
        tick_ms.append(1e3 * (time.perf_counter() - t))
        plans.append((produced, sorted(
            (int(k[1].number), p.node, p.base_reserved) for k, p in spec._plans.items()
        )))
        wave = []
        for i in range(size["wave"]):
            wave.append(f"sp{w:02d}-{i:02d}")
            stack.cluster.create_pod(hot_pod(wave[-1], int(rng.choice(HOT_SHAPES))))
        stack.scheduler.run_until_idle(max_wall_s=300)
        names += wave
        for host in sorted({stack.cluster.get_pod(f"default/{n}").node_name for n in wave}):
            agent.refresh(host)
    if platform != "cpu":
        torch.cuda.synchronize()
    wall = time.monotonic() - t0
    lat = singleton_latencies(stack, names)
    out = dict(
        platform=platform, pods=len(names), bindings=bindings_of(stack, names),
        plans=plans, stats=spec.stats(),
        launches=cuda_kernel.launches, spec_launches=spec.kernel.launches,
        spec_row_updates=spec.kernel.row_updates,
        serve_launches=stack.batch._kern.launches,
        row_update_launches=kernel_mod.row_update_launches,
        dispatch_count=stack.batch.dispatch_count, **dispatch_health(stack.batch),
        spec_restacks=spec._fleet.restacks, spec_delta_syncs=spec._fleet.delta_syncs,
        overcommitted=over_capacity(stack), accounting_gap=accounting_gap(stack),
        speculate_ms_median=statistics.median(tick_ms),
        speculate_ms_max=max(tick_ms),
        spec_bind_ms_median=statistics.median(bind_ms) if bind_ms else None,
        spec_bind_ms_max=max(bind_ms, default=None),
        wall_s=wall, pods_per_s=len(lat) / wall if wall else 0.0,
        p50_ms=pct_ms(lat, 0.5), p99_ms=pct_ms(lat, 0.99),
    )
    spec.kernel.evaluate = inner_evaluate
    if platform != "cpu" and kept:
        out["update_rows"] = update_rows_device_ms(spec)
        out["concurrent"] = concurrent_eval(stack, spec, kept[0])
    return out


def rebalance_layout(size: dict) -> "tuple[dict[str, str], list[str]]":
    """(h2)'s pools: ``pool`` v5e hosts (rb-e), and the hosts of
    ``frag_slices`` v5p slices (rb-p, in slice order)."""
    step = max(size["v5e_hosts"] // size["pool"], 1)
    pools = {f"v5e-{h * step:04d}": "rb-e" for h in range(size["pool"])}
    frag = [f"v5p-{s * (size['slices'] // size['frag_slices']):03d}-{i}"
            for s in range(size["frag_slices"]) for i in range(4)]
    pools.update({h: "rb-p" for h in frag})
    return pools, frag


def run_rebalance(platform: str, size: dict):
    """(h2): the rb-e pool filled at priority 1, 1x1x1 topology gangs on
    the rb-p slices with the gangs on each slice's diagonal deleted (two
    free islands a slice), an elastic gang (min 4, max 16, size 8; 16
    members), both at priority 5, and a parked priority-100 plain gang of
    ``gang`` x 8 chips on rb-e (preemption off in this stack: only the
    rebalancer can admit it, through at most 32 victims); then
    resync and rebalance passes until one changes nothing. Returns the run
    and its stack (the reconciler run rebuilds a stack over its cluster)."""
    from yoda_tpu_torch.api.types import PodSpec
    from yoda_tpu_torch.ops import cuda_kernel
    from yoda_tpu_torch.ops import kernel as kernel_mod

    pools, frag = rebalance_layout(size)
    # A held scheduling clock, as in (h3): a preempted victim's retry
    # backoff then never expires by wall time, so how many dispatches its
    # retries take cannot depend on the host's speed — on the wall clock a
    # slow host retried victims the fast one did not, and the card's
    # dispatch count left the CPU's.
    stack, _agent = build_fleet(
        platform, 16, pools=pools, slices=size["slices"], v5e_hosts=size["v5e_hosts"],
        clock=SteppedClock(0.0), enable_preemption=False, rebalance_max_victims=32,
        rebalance_min_gain=1e-4,
    )
    cuda_kernel.launches = cuda_kernel.joint_fit_launches = 0
    kernel_mod.row_update_launches = 0
    names: list[str] = []

    def create(pods, selector=None):
        for name, labels in pods:
            names.append(name)
            stack.cluster.create_pod(
                PodSpec(name, labels=dict(labels), node_selector=selector or {})
            )
        stack.scheduler.run_until_idle(max_wall_s=300)

    create([(f"fill{i:03d}", {"tpu/chips": "8", "tpu/priority": "1"})
            for i in range(size["pool"])], {"pool": "rb-e"})
    create([(f"t{i:02d}-0", {"tpu/gang": f"t{i:02d}", "tpu/topology": "1x1x1",
                             "tpu/chips": "4", "tpu/priority": "5"})
            for i in range(len(frag))],
           {"pool": "rb-p"})
    diagonal = {h for h in frag if h.endswith(("-0", "-3"))}
    for p in list(stack.cluster.list_pods()):
        if p.name.startswith("t") and p.node_name in diagonal:
            stack.cluster.delete_pod(p.key)
    stack.scheduler.run_until_idle(max_wall_s=60)
    create([(f"el-{i:02d}", {"tpu/gang": "el", "tpu/gang-size": "8",
                             "tpu/min-members": "4", "tpu/max-members": "16",
                             "tpu/chips": "4", "tpu/generation": "v5e",
                             "tpu/priority": "5"})
            for i in range(16)])
    create([(f"hi-{i:02d}", {"tpu/gang": "hi", "tpu/gang-size": str(size["gang"]),
                             "tpu/chips": "8", "tpu/priority": "100"})
            for i in range(size["gang"])], {"pool": "rb-e"})
    parked = sum(stack.cluster.get_pod(f"default/hi-{i:02d}").node_name is None
                 for i in range(size["gang"]))
    t = time.perf_counter()
    resync = stack.reconciler.resync()
    resync_ms = 1e3 * (time.perf_counter() - t)
    passes, pass_ms, gang_completion_ms = [], [], None
    for _ in range(12):
        t = time.perf_counter()
        report = stack.rebalancer.run_once()
        pass_ms.append(1e3 * (time.perf_counter() - t))
        view = dataclasses.asdict(report)
        passes.append(view)
        stack.scheduler.run_until_idle(max_wall_s=300)
        if report.admitted_gangs and gang_completion_ms is None:
            gang_completion_ms = 1e3 * (time.perf_counter() - t)
        if not (report.moves or report.aborted_moves or report.preempted or report.resizes):
            break
    if platform != "cpu":
        torch.cuda.synchronize()
    bound = bindings_of(stack, names)
    hi_bound = sum(bound[f"hi-{i:02d}"] is not None for i in range(size["gang"]))
    out = dict(
        platform=platform, pods=len(names), bindings=bound, passes=passes,
        resync=dataclasses.asdict(resync) | {"duration_ms": None},
        resync_ms=resync_ms, pass_ms=pass_ms, parked_before=parked, hi_bound=hi_bound,
        el_bound=sum(bound[f"el-{i:02d}"] is not None for i in range(16)),
        effective_el=stack.gang.effective_size("el"),
        gang_completion_ms=gang_completion_ms,
        unbinds=stack.binder.unbinds, launches=cuda_kernel.launches,
        joint_fit_launches=cuda_kernel.joint_fit_launches,
        row_update_launches=kernel_mod.row_update_launches,
        dispatch_count=stack.batch.dispatch_count, **dispatch_health(stack.batch),
        overcommitted=over_capacity(stack), accounting_gap=accounting_gap(stack),
        waiting=len(stack.framework.waiting_pods()),
    )
    return out, stack


def run_reconcile(platform: str, size: dict, cluster) -> dict:
    """(h3): the leader that ran (h2) dies with a plain gang half bound (2 of
    4 members bound, written to the cluster as its last act); a new stack
    (on a held scheduling clock) is built over the same cluster, resyncs
    (the gang is adopted and completes), and after a ghost binding, a
    dropped deletion and a leaked claim the drift pass repairs them. Both
    reports and each pass's ms."""
    from yoda_tpu_torch.api.types import PodSpec
    from yoda_tpu_torch.config import SchedulerConfig
    from yoda_tpu_torch.ops import cuda_kernel
    from yoda_tpu_torch.ops import kernel as kernel_mod
    from yoda_tpu_torch.standalone import build_stack

    cuda_kernel.launches = cuda_kernel.joint_fit_launches = 0
    kernel_mod.row_update_launches = 0

    def free_hosts(n: int) -> list[str]:
        held = {p.node_name for p in cluster.list_pods() if p.node_name}
        return [f"v5e-{h:04d}" for h in range(size["v5e_hosts"] - 1, 0, -1)
                if f"v5e-{h:04d}" not in held][:n]

    free = free_hosts(2)
    labels = {"tpu/gang": "orphan", "tpu/gang-size": "4", "tpu/chips": "8",
              "tpu/generation": "v5e"}
    for i in range(4):
        pod = PodSpec(f"orphan-{i}", labels=dict(labels))
        if i < 2:
            pod.node_name, pod.phase = free[i], "Running"
        cluster.create_pod(pod)
    t = time.perf_counter()
    # A held scheduling clock: the leftover fill pods' retry backoff then
    # never expires by wall time, so whether a fill burst pops (and, as a
    # gang member, re-queues behind its sibling) an orphan member cannot
    # depend on the host's speed — on the wall clock a slow run flipped
    # the two members' hosts between the card and the CPU.
    stack = build_stack(cluster=cluster, config=SchedulerConfig(
        kernel_platform=platform, batch_requests=16, enable_preemption=False),
        clock=SteppedClock(0.0))
    build_ms = 1e3 * (time.perf_counter() - t)
    t = time.perf_counter()
    resync = stack.reconciler.resync()
    resync_ms = 1e3 * (time.perf_counter() - t)
    stack.scheduler.run_until_idle(max_wall_s=300)
    orphan = {f"orphan-{i}": stack.cluster.get_pod(f"default/orphan-{i}").node_name
              for i in range(4)}
    free = free_hosts(2)
    ghost = PodSpec("ghost", labels={"tpu/chips": "8", "tpu/generation": "v5e"})
    ghost.node_name, ghost.phase = free[0], "Running"
    dropped = next(p for p in cluster.list_pods()
                   if p.node_name and p.name.startswith("fill"))
    cluster.suppress_kinds.add("Pod")
    try:
        cluster.create_pod(ghost)
        cluster.delete_pod(dropped.key)
    finally:
        cluster.suppress_kinds.clear()
    stack.accountant._claim("leaked-uid", free[1], 8)
    t = time.perf_counter()
    drift = stack.reconciler.reconcile()
    reconcile_ms = 1e3 * (time.perf_counter() - t)
    stack.scheduler.run_until_idle(max_wall_s=60)
    return dict(
        platform=platform, orphan=orphan, dropped=dropped.name,
        resync=dataclasses.asdict(resync) | {"duration_ms": None},
        drift=dataclasses.asdict(drift), build_ms=build_ms, resync_ms=resync_ms,
        reconcile_ms=reconcile_ms, overcommitted=over_capacity(stack),
        accounting_gap=accounting_gap(stack), launches=cuda_kernel.launches,
        joint_fit_launches=cuda_kernel.joint_fit_launches,
        row_update_launches=kernel_mod.row_update_launches,
    )


def run_threaded(platform: str, size: dict, spec_enabled: bool = True) -> dict:
    """(h4): the rebalancer's run_forever on a second thread (passes every
    ``period_s``, 50 ms speculation ticks) while the main thread serves
    ``threaded_pods`` hot-shape singletons at K = 16 in 16 waves over about
    ``threaded_s`` seconds, and in two of the waves two plain gangs each,
    which the serve path places in one joint pass (fleet_eval, then
    joint_fit). The start of every rebalance pass is recorded, so the
    check can require one that began inside the serve window.
    Every kernel object's launch counts are zeroed just before the window;
    pods/s and latencies count the serve waves only. Invariants only: timing decides who wins a race, so the
    bindings are not compared with any other run. Counted over the window
    too: the burst rows whose serve-time check failed (``_pick_checks``
    False) and the serve path's dispatches; ``spec_enabled=False`` runs
    the same window with the speculative cache off."""
    import logging
    import threading

    from yoda_tpu_torch.api.types import PodSpec, pod_admits_on
    from yoda_tpu_torch.ops import cuda_kernel
    from yoda_tpu_torch.ops import kernel as kernel_mod

    stack, _agent = build_fleet(platform, 16, slices=size["slices"],
                                v5e_hosts=size["v5e_hosts"], spec_enabled=spec_enabled)
    spec, rb = stack.speculation, stack.rebalancer
    errors: list[str] = []
    pick_failures = [0]
    inner_pick = stack.batch._pick_checks

    def counted_pick(*args, **kw):
        ok = inner_pick(*args, **kw)
        pick_failures[0] += not ok
        return ok

    stack.batch._pick_checks = counted_pick

    class Errors(logging.Handler):
        def emit(self, record):
            errors.append(record.getMessage())

    handler = Errors(level=logging.ERROR)
    logging.getLogger("yoda_tpu_torch").addHandler(handler)
    consumed: list = []
    inner_revalidate = spec.revalidate

    def noted_revalidate(plan, pod, snapshot):
        ok = inner_revalidate(plan, pod, snapshot)
        if ok:
            consumed.append((pod, plan.node))
        return ok

    spec.revalidate = noted_revalidate
    pass_starts: list[float] = []
    inner_pass = rb.run_once

    def timed_pass():
        pass_starts.append(time.monotonic())
        return inner_pass()

    rb.run_once = timed_pass
    rng = np.random.default_rng(9)
    names = []
    for i in range(16):  # warm: the shapes are seen, the fleet is resident
        names.append(f"warm{i:02d}")
        stack.cluster.create_pod(hot_pod(names[-1], int(rng.choice(HOT_SHAPES))))
    stack.scheduler.run_until_idle(max_wall_s=300)
    stack.reconciler.resync()
    serve = stack.batch._kern
    for kern in (serve, spec.kernel):
        kern.launches = kern.joint_fit_launches = kern.row_updates = 0
    cuda_kernel.launches = cuda_kernel.joint_fit_launches = 0
    kernel_mod.row_update_launches = 0
    pick_failures[0] = 0
    b = stack.batch
    window_base = (b.dispatch_count, b.burst_dispatches, b.burst_served, b.burst_invalidated)
    stop = threading.Event()
    thread = threading.Thread(
        target=rb.run_forever, args=(stop,),
        kwargs={"period_s": size["period_s"], "spec_period_s": 0.05}, daemon=True,
    )
    per_wave = size["threaded_pods"] // 16
    gang_waves = {5: ("tg0", "tg1"), 11: ("tg2", "tg3")}
    t0 = time.monotonic()
    thread.start()
    try:
        for w in range(16):
            for i in range(per_wave):
                names.append(f"th{w:02d}-{i:02d}")
                stack.cluster.create_pod(hot_pod(names[-1], int(rng.choice(HOT_SHAPES))))
            for g in gang_waves.get(w, ()):
                for m in range(4):
                    names.append(f"{g}-{m}")
                    stack.cluster.create_pod(PodSpec(names[-1], labels={
                        "tpu/gang": g, "tpu/gang-size": "4", "tpu/chips": "8",
                        "tpu/generation": "v5e"}))
            stack.scheduler.run_until_idle(max_wall_s=300)
            time.sleep(max(t0 + (w + 1) * size["threaded_s"] / 16 - time.monotonic(), 0))
        serve_end = time.monotonic()
    finally:
        stop.set()
        thread.join(timeout=60)
        spec.revalidate = inner_revalidate
        rb.run_once = inner_pass
        logging.getLogger("yoda_tpu_torch").removeHandler(handler)
    if platform != "cpu":
        torch.cuda.synchronize()
    wall = serve_end - t0
    snap = stack.informer.snapshot()
    bad_plans = []
    for pod, node in consumed:
        live = stack.cluster.get_pod(pod.key)
        if live is None or live.node_name != node:
            continue  # Reserve lost the race: the full path placed it
        ni = snap.get(node) if node in snap else None
        if (ni is None or ni.tpu is None or ni.tpu.generation != "v5e"
                or not pod_admits_on(ni.node, pod)[0]):
            bad_plans.append((pod.name, node))
    gangs = {g: sum(stack.cluster.get_pod(f"default/{g}-{m}").node_name is not None
                    for m in range(4)) for pair in gang_waves.values() for g in pair}
    lat = singleton_latencies(stack, [n for n in names if n.startswith("th")])
    window_pods = sum(n.startswith(("th", "tg")) for n in names)
    dispatches, bursts, served, invalidated = (
        now - then for now, then in zip(
            (b.dispatch_count, b.burst_dispatches, b.burst_served, b.burst_invalidated),
            window_base))
    return dict(
        platform=platform, spec_enabled=spec_enabled, window_pods=window_pods,
        pick_check_failures=pick_failures[0], burst_invalidated=invalidated,
        burst_dispatches=bursts, burst_served=served, serve_dispatches=dispatches,
        serve_dispatches_per_pod=dispatches / window_pods,
        serve_launches_per_pod=serve.launches / window_pods,
        pods=len(names), alive=thread.is_alive(), errors=errors[:5],
        bound=sum(v is not None for v in bindings_of(stack, names).values()),
        gangs=gangs, consumed=len(consumed), bad_plans=bad_plans,
        stats=spec.stats(), rebalance_passes=rb.passes,
        passes_begun_in_window=sum(t < serve_end for t in pass_starts),
        serve_launches=serve.launches, spec_launches=spec.kernel.launches,
        serve_joint_fit_launches=serve.joint_fit_launches,
        spec_joint_fit_launches=spec.kernel.joint_fit_launches,
        fused_plan_dispatches=stack.batch.fused_plan_dispatches,
        launches=cuda_kernel.launches, joint_fit_launches=cuda_kernel.joint_fit_launches,
        row_update_launches=kernel_mod.row_update_launches,
        **dispatch_health(stack.batch),
        overcommitted=over_capacity(stack), accounting_gap=accounting_gap(stack),
        wall_s=wall, pods_per_s=len(lat) / wall if wall else 0.0,
        p50_ms=pct_ms(lat, 0.5), p99_ms=pct_ms(lat, 0.99),
    )


def run_background(platform: str, size: dict = BACKGROUND_FULL,
                   threaded: bool = True) -> dict:
    """Run (h) on one kernel_platform: (h1)-(h3), and (h4) when asked."""
    t = time.monotonic()
    h1 = run_speculation(platform, size)
    h1["part_s"], t = time.monotonic() - t, time.monotonic()
    h2, stack = run_rebalance(platform, size)
    h2["part_s"], t = time.monotonic() - t, time.monotonic()
    h3 = run_reconcile(platform, size, stack.cluster)
    h3["part_s"], t = time.monotonic() - t, time.monotonic()
    h4 = run_threaded(platform, size) if threaded else None
    if h4 is not None:
        h4["part_s"] = time.monotonic() - t
    return dict(h1=h1, h2=h2, h3=h3, h4=h4)


BACKGROUND_PARITY = {
    "h1": ("bindings", "plans", "stats", "dispatch_count", "spec_restacks",
           "spec_delta_syncs"),
    "h2": ("bindings", "passes", "resync", "parked_before", "hi_bound", "el_bound",
           "effective_el", "unbinds", "dispatch_count"),
    "h3": ("orphan", "dropped", "resync", "drift"),
}


def check_background_run(run: dict, size: dict) -> None:
    """The checks of one run (h) that need no second run."""
    name = f"run h ({run['h1']['platform']})"
    for part in ("h1", "h2", "h3") + (("h4",) if run["h4"] else ()):
        r = run[part]
        if r["overcommitted"] or r["accounting_gap"]:
            raise AssertionError(f"{name} {part}: over capacity {r['overcommitted']}, "
                                 f"accounting != bound pods at {r['accounting_gap']}")
    h1, h2, h3, h4 = run["h1"], run["h2"], run["h3"], run["h4"]
    if demoted(h1) or any(v is None for v in h1["bindings"].values()):
        raise AssertionError(f"{name} h1: unbound pods or {demoted(h1)}")
    if not h1["stats"]["hits"] or h1["stats"]["ticks"] != size["waves"]:
        raise AssertionError(f"{name} h1: no speculative hit: {h1['stats']}")
    if h1["dispatch_count"] + h1["stats"]["hits"] != h1["pods"]:
        raise AssertionError(
            f"{name} h1: {h1['dispatch_count']} dispatches + {h1['stats']['hits']} "
            f"hits for {h1['pods']} pods"
        )
    if not h2["parked_before"] or h2["hi_bound"] != size["gang"]:
        raise AssertionError(f"{name} h2: gang hi parked {h2['parked_before']}, "
                             f"bound after the passes {h2['hi_bound']}")
    passes = h2["passes"]
    if not any(p["preempted"] for p in passes) or not any(p["resizes"] for p in passes):
        raise AssertionError(f"{name} h2: no preemption or no resize: {passes}")
    if passes[-1]["moves"] or passes[-1]["preempted"] or passes[-1]["resizes"]:
        raise AssertionError(f"{name} h2: the passes did not settle: {passes[-1]}")
    if h2["waiting"] or demoted(h2):
        raise AssertionError(f"{name} h2: {h2['waiting']} at Permit, {demoted(h2)}")
    if h3["resync"]["adopted_gangs"] != ["orphan"] or None in h3["orphan"].values():
        raise AssertionError(f"{name} h3: the half-bound gang: {h3['resync']}, {h3['orphan']}")
    d = h3["drift"]
    if (d["ghost_pods"], d["leaked_reservations"]) != (2, 1):
        raise AssertionError(f"{name} h3: drift report {d}")
    if h4 is not None:
        if h4["alive"] or h4["errors"] or demoted(h4) or h4["bad_plans"]:
            raise AssertionError(
                f"{name} h4: thread alive {h4['alive']}, errors {h4['errors']}, "
                f"dispatch chain {demoted(h4)}, plans that do not admit "
                f"their pod {h4['bad_plans']}"
            )
        if h4["bound"] != h4["pods"] or set(h4["gangs"].values()) != {4}:
            raise AssertionError(f"{name} h4: {h4['bound']}/{h4['pods']} bound, gangs {h4['gangs']}")
        if not h4["passes_begun_in_window"] or not h4["stats"]["ticks"]:
            raise AssertionError(
                f"{name} h4: no rebalance pass began beside the serve loop: {h4}")
        if not h4["fused_plan_dispatches"]:
            raise AssertionError(f"{name} h4: the serve thread took no joint pass")


def check_background(g: dict, c: dict, size: dict) -> None:
    """Run (h) on the card against the same script on the CPU: the
    deterministic parts equal, every check of each run, and the card run's
    launches where they must be."""
    for part, keys in BACKGROUND_PARITY.items():
        diff = [k for k in keys if g[part][k] != c[part][k]]
        if diff:
            raise AssertionError(f"run h {part}: cuda != cpu in {diff}")
    check_background_run(g, size)
    check_background_run(c, size)
    h1 = g["h1"]
    if h1["spec_launches"] < h1["stats"]["speculations"] or not h1["spec_launches"]:
        raise AssertionError(f"run h1: {h1['spec_launches']} private fleet_eval launches "
                             f"for {h1['stats']['speculations']} plans")
    if not 0 < h1["spec_row_updates"] <= h1["spec_delta_syncs"]:
        raise AssertionError(f"run h1: {h1['spec_row_updates']} private update_rows for "
                             f"{h1['spec_delta_syncs']} delta syncs")
    if h1["launches"] != h1["spec_launches"] + h1["serve_launches"]:
        raise AssertionError(f"run h1: {h1['launches']} launches, {h1['spec_launches']} "
                             f"private + {h1['serve_launches']} serve")
    h4 = g["h4"]
    if h4 and not (h4["serve_launches"] and h4["spec_launches"]
                   and h4["launches"] == h4["serve_launches"] + h4["spec_launches"]):
        raise AssertionError(f"run h4: {h4['launches']} launches, serve thread "
                             f"{h4['serve_launches']}, speculation thread "
                             f"{h4['spec_launches']}")
    if h4 and not (0 < h4["serve_joint_fit_launches"] == h4["joint_fit_launches"]
                   == h4["fused_plan_dispatches"] and not h4["spec_joint_fit_launches"]):
        raise AssertionError(f"run h4: {h4['joint_fit_launches']} joint_fit launches, "
                             f"serve thread {h4['serve_joint_fit_launches']}, "
                             f"speculation thread {h4['spec_joint_fit_launches']}, "
                             f"{h4['fused_plan_dispatches']} fused dispatches")
    for part in ("h1", "h2"):
        if c[part]["launches"] or c[part]["row_update_launches"]:
            raise AssertionError(f"run {part}: the CPU run launched on the card")


def print_background(run: dict, smi: str) -> None:
    """One line per part of a run (h), less its bindings and plans; the
    rebalance passes as counts."""
    for part in ("h1", "h2", "h3", "h4"):
        if run[part] is None:
            continue
        summary = {k: v for k, v in run[part].items()
                   if k not in ("bindings", "plans", "passes")}
        if "passes" in run[part]:
            summary["passes"] = [
                {k: (len(v) if isinstance(v, (list, dict)) else v) for k, v in p.items()}
                for p in run[part]["passes"]
            ]
        print(f"background ({part}) {run['h1']['platform']} [{smi}]:", json.dumps(summary))


# Run (i): the node health path on the 5,000-node fleet — the health
# ladder on stopped heartbeats, fencing through the admission rows the card
# reads, condition signals, drains and gang-whole repair. The smaller size
# is the tests' copy of the same script.
NODEHEALTH_FULL = dict(slices=512, v5e_hosts=2952, topo=16, plain=8, gang=16,
                       singles=128, serve=256, stop=64)
NODEHEALTH_SMALL = dict(slices=16, v5e_hosts=96, topo=4, plain=4, gang=4,
                        singles=16, serve=32, stop=16)
# How long one drain of the queue may take before run (i) fails: its
# scheduling clock is stepped by hand, so a pod left at Permit would hold a
# drain for all of it.
NODEHEALTH_DRAIN_S = 120.0


class SteppedClock:
    """A clock the script advances by hand: run (i)'s wall clock of the
    agents' publish stamps (the monitor's ladder reads it) and its
    scheduling clock (queue backoff, Permit deadlines, drain deadlines).
    Stepping both by hand makes the card and CPU runs take the same
    decisions whatever their speed."""

    def __init__(self, t: float) -> None:
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


def nodehealth_pools(size: dict) -> "dict[str, str]":
    """Run (i)'s pools: ``gang`` v5e hosts for the elastic gang (nh-el),
    ``2 * gang`` for the two plain gangs of (i4) (nh-q), and one v5p slice
    per topology gang (nh-t<i>, slices spread over the fleet), so each
    2x1x1 gang leaves its slice two free hosts to be patched or drained
    into."""
    g = size["gang"]
    pools = {f"v5e-{h:04d}": "nh-el" for h in range(g)}
    pools.update({f"v5e-{h:04d}": "nh-q" for h in range(g, 3 * g)})
    step = size["slices"] // size["topo"]
    for t in range(size["topo"]):
        pools.update({f"v5p-{t * step:03d}-{i}": f"nh-t{t:02d}" for i in range(4)})
    return pools


def nodehealth_waves(size: dict, seed: int = 12):
    """Run (i)'s two waves of (name, labels, node selector) and each gang's
    (kind, members): first the pool-bound gangs (the elastic gang el, the
    plain gangs p0 and p1), then the topology gangs (2x1x1 on v5p), the
    other plain gangs and the singletons."""
    rng = np.random.default_rng(seed)
    g = size["gang"]
    v5e = {"tpu/chips": "8", "tpu/generation": "v5e"}
    gangs = {"el": ("elastic", g)}
    first = [(f"el-{i:02d}", {"tpu/gang": "el", "tpu/gang-size": str(g),
                              "tpu/min-members": str(g // 2),
                              "tpu/max-members": str(g), **v5e}, {"pool": "nh-el"})
             for i in range(g)]
    for j in (0, 1):
        gangs[f"p{j}"] = ("plain", g)
        first += [(f"p{j}-{i:02d}", {"tpu/gang": f"p{j}", "tpu/gang-size": str(g), **v5e},
                   {"pool": "nh-q"}) for i in range(g)]
    second = []
    for t in range(size["topo"]):
        gangs[f"t{t:02d}"] = ("topology", 2)
        second += [(f"t{t:02d}-{i}", {"tpu/gang": f"t{t:02d}", "tpu/topology": "2x1x1",
                                      "tpu/chips": "4"}, {"pool": f"nh-t{t:02d}"})
                   for i in range(2)]
    for j in range(2, size["plain"]):
        gangs[f"p{j}"] = ("plain", g)
        second += [(f"p{j}-{i:02d}", {"tpu/gang": f"p{j}", "tpu/gang-size": str(g), **v5e},
                    None) for i in range(g)]
    second += [(f"s{i:03d}", {"tpu/chips": str(int(rng.choice(HOT_SHAPES))),
                              "tpu/generation": "v5e"}, None)
               for i in range(size["singles"])]
    return [first, second], gangs


def abs_err(got: torch.Tensor, want: torch.Tensor) -> int:
    """The largest absolute difference of two integer or bool tensors (on
    any devices), 0 when empty."""
    if not want.numel():
        return 0
    return int((got.cpu().to(torch.int64) - want.to(torch.int64)).abs().max())


def gang_of(name: str) -> "str | None":
    """The gang a run (i) pod belongs to, None for a singleton."""
    return None if name.startswith(("s", "serve", "probe")) else name.rsplit("-", 1)[0]


def run_nodehealth(platform: str, size: dict = NODEHEALTH_FULL) -> dict:
    """Run (i) on one kernel_platform (module docstring): bindings, node
    states, fence sets and every monitor pass's RepairReport for the
    comparison with the other platform; pass and repair times, the counters
    across each fence flip and the kernels' launches; and on the card every
    ``fleet_eval`` and ``joint_fit`` call's result against its plain
    version."""
    from yoda_tpu_torch.api.types import PodSpec
    from yoda_tpu_torch.ops import cuda_kernel
    from yoda_tpu_torch.ops import kernel as kernel_mod

    now, clock = SteppedClock(1_000_000.0), SteppedClock(1_000.0)
    # bind_workers 0: every unbind inline and in order, so both platforms
    # requeue in one order (tests/test_torch_nodehealth.py holds the
    # default fan-out against the reference on what no order changes).
    stack, agent = build_fleet(
        platform, 16, pools=nodehealth_pools(size), slices=size["slices"],
        v5e_hosts=size["v5e_hosts"], clock=clock, now_fn=now, bind_workers=0,
    )
    monitor, batch = stack.nodehealth, stack.batch
    monitor.now_fn = now
    # The monitor's own clock times the repairs (RepairReport.durations_ms)
    # and no deadline of this script can pass on it: the first drain's
    # window is 300 s, the second's 0, and every patch completes in the
    # drain after its pass, long before patch_grace_s.
    monitor.clock = time.monotonic
    suspect_s, down_s = monitor.suspect_after_s, monitor.down_after_s
    binds: list[tuple[float, str, str]] = []  # (host time, pod, node)
    inner_bind = stack.cluster.bind_pod

    def noted_bind(key, node):
        inner_bind(key, node)
        binds.append((time.perf_counter(), key.split("/", 1)[1], node))

    stack.cluster.bind_pod = noted_bind
    kept = KeptKernels()
    names: list[str] = []

    def create(pods):
        for name, labels, selector in pods:
            names.append(name)
            stack.cluster.create_pod(
                PodSpec(name, labels=dict(labels), node_selector=selector or {}))
        drain()

    def drain():
        stack.scheduler.run_until_idle(max_wall_s=NODEHEALTH_DRAIN_S)
        if stack.framework.waiting_pods():
            raise AssertionError(f"run i ({platform}): pods left at Permit: "
                                 f"{[w.pod.name for w in stack.framework.waiting_pods()]}")

    def bound() -> dict:
        return {p.name: p.node_name for p in stack.cluster.list_pods()}

    def counters() -> dict:
        return dict(restacks=batch.restacks,
                    row_update_launches=kernel_mod.row_update_launches,
                    admission_patched=batch.admission_patched,
                    fleet_eval=cuda_kernel.launches, joint_fit=cuda_kernel.joint_fit_launches)

    fence_log: list = []

    def note_fence():
        fence_log.append((time.perf_counter(), monitor.fenced_nodes()))

    flips: list[dict] = []

    def flip(label: str, fn):
        """A fence-changing step and the counters across it."""
        before = counters()
        out = fn()
        note_fence()
        after = counters()
        flips.append(dict(step=label, fenced=len(monitor.fenced_nodes()),
                          **{k: after[k] - before[k] for k in before}))
        return out

    passes: list[dict] = []

    def monitor_pass(label: str):
        t = time.perf_counter()
        report = flip(label, monitor.run_once)
        ms = 1e3 * (time.perf_counter() - t)
        passes.append(dict(
            step=label, ms=ms, start=t,
            report={k: (sorted(v) if k == "durations_ms" else v)
                    for k, v in dataclasses.asdict(report).items()},
            durations_ms=dict(report.durations_ms),
            states={n: s.value for n, s in sorted(monitor.states().items())
                    if s.value != "healthy"},
            fenced=sorted(monitor.fenced_nodes()),
        ))
        return report

    def rebind_ms(p: dict, gangs_of_pass: list) -> dict:
        """Host ms from the pass's start to each repaired gang's last
        member bind after it (None while a member is unbound)."""
        out = {}
        for gname in gangs_of_pass:
            after = [t for t, n, _ in binds if t > p["start"] and gang_of(n) == gname]
            out[gname] = 1e3 * (max(after) - p["start"]) if after else None
        singles = [t for t, n, _ in binds if t > p["start"] and gang_of(n) is None]
        if p["report"]["singles"]:
            out["singletons"] = 1e3 * (max(singles) - p["start"]) if singles else None
        return out

    kept.install()
    kernel_mod.row_update_launches = 0
    phase_launches: dict[str, dict] = {}
    phase_bindings: dict[str, dict] = {}
    t0 = time.monotonic()
    try:
        waves, gangs = nodehealth_waves(size)
        base = counters()
        for wave in waves:
            create(wave)
        agent.publish_all()
        note_fence()
        start = bound()
        if None in start.values():
            raise AssertionError(f"run i ({platform}): the fleet did not bind: "
                                 f"{[n for n, v in start.items() if v is None][:5]}")
        phase_bindings["i0"] = start
        phase_launches["i0"] = counters()
        note_fence()
        # (i1) the silence ladder on 64 hosts holding gang members and
        # singletons; half flap back inside the debounce window.
        gang_hosts = {h for n, h in start.items() if gang_of(n)}
        topo_hosts = [start[f"t{t:02d}-0"] for t in range(size["topo"])]
        plain_hosts = [(start[f"p{j}-00"], start[f"p{j}-01"]) for j in range(2, size["plain"])]
        el_hosts = [start[f"el-{i:02d}"] for i in range(size["gang"] // 4)]
        single_hosts = sorted({h for n, h in start.items() if not gang_of(n)} - gang_hosts)
        half = size["stop"] // 2
        n_single = size["stop"] - len(topo_hosts) - 2 * len(plain_hosts) - len(el_hosts)
        if len(single_hosts) < n_single:
            raise AssertionError(f"run i: {len(single_hosts)} singleton hosts, want {n_single}")
        down = (topo_hosts[: len(topo_hosts) // 2] + [a for a, _ in plain_hosts] + el_hosts)
        down += single_hosts[: half - len(down)]
        stopped = topo_hosts + [h for pair in plain_hosts for h in pair] + el_hosts
        stopped += single_hosts[:n_single]
        flap = [h for h in stopped if h not in down]
        # The probes ask for more chips than any host has, under the plain
        # singletons' admission key: the first folds every change so far
        # into the cached admission row, the second dispatches right after
        # the flip, so the row's patch count is the flip's alone.
        probe = {"tpu/chips": "9", "tpu/generation": "v5e"}
        create([("probe-0", probe, None)])
        for h in stopped:
            agent.stop_heartbeat(h)
        now.advance(suspect_s + 1.0)
        agent.publish_all()
        note_fence()
        monitor_pass("i1 suspect")
        flip("i1 probe", lambda: create([("probe-1", probe, None)]))
        for n in ("probe-0", "probe-1"):
            stack.cluster.delete_pod(f"default/{n}")
            names.remove(n)
        fenced = set(monitor.fenced_nodes())
        if fenced != set(stopped):
            raise AssertionError(f"run i ({platform}): fenced {len(fenced)} hosts, "
                                 f"stopped {len(stopped)}")
        rng = np.random.default_rng(13)
        t = time.monotonic()
        create([(f"serve{i:03d}", {"tpu/chips": str(int(rng.choice(HOT_SHAPES))),
                                   "tpu/generation": "v5e"}, None)
                for i in range(size["serve"])])
        serve_s = time.monotonic() - t
        for h in flap:
            agent.resume_heartbeat(h)
        note_fence()
        monitor_pass("i1 flap")
        now.advance(down_s - suspect_s)
        agent.publish_all()
        note_fence()
        monitor_pass("i1 down")
        drain()
        passes[-1]["rebind_ms"] = rebind_ms(
            passes[-1], passes[-1]["report"]["patched"] + passes[-1]["report"]["requeued"])
        phase_launches["i1"] = counters()
        phase_bindings["i1"] = bound()
        # (i2) condition signals at event time.
        now_bound = bound()
        killed = now_bound[f"t{size['topo'] - 1:02d}-1"]
        not_ready = now_bound[f"p{size['plain'] - 1}-02"]
        agent.stop_heartbeat(killed)  # the host is gone: its agent too
        flip("i2 kill", lambda: stack.cluster.kill_node(killed))
        ghost_left = stack.accountant.chips_in_use(killed)
        flip("i2 not ready", lambda: stack.cluster.set_node_ready(not_ready, False))
        event_states = {h: monitor.state_of(h).value for h in (killed, not_ready)}
        monitor_pass("i2 repair")
        drain()
        passes[-1]["rebind_ms"] = rebind_ms(
            passes[-1], passes[-1]["report"]["patched"] + passes[-1]["report"]["requeued"])
        phase_launches["i2"] = counters()
        phase_bindings["i2"] = bound()
        # (i3) a drain the rebalancer migrates, then one past its deadline.
        now_bound = bound()
        drained_host = now_bound[f"t{size['topo'] - 2:02d}-0"]
        flip("i3 drain", lambda: monitor.drain(drained_host))
        t = time.perf_counter()
        rb = flip("i3 rebalance", stack.rebalancer.run_once)
        rebalance_ms = 1e3 * (time.perf_counter() - t)
        drain()
        evacuated = bound()[f"p{size['plain'] - 2}-03"]
        flip("i3 deadline 0", lambda: monitor.drain(evacuated, deadline_s=0.0))
        monitor_pass("i3 evacuate")
        drain()
        phase_launches["i3"] = counters()
        phase_bindings["i3"] = bound()
        # (i4) whole requeue of the two pool gangs, then the fence reopens.
        now_bound = bound()
        k = size["gang"] // 2 + 1
        lost = [now_bound[f"p{j}-{i:02d}"] for j in (0, 1) for i in range(k)]
        for h in lost:
            agent.stop_heartbeat(h)
        now.advance(down_s + 1.0)
        agent.publish_all()
        note_fence()
        monitor_pass("i4 down")
        drain()
        parked = {g: sum(bound()[f"{g}-{i:02d}"] is not None for i in range(size["gang"]))
                  for g in ("p0", "p1")}
        flip("i4 resume", lambda: [agent.resume_heartbeat(h) for h in lost])
        monitor_pass("i4 reopen")
        fused_before, joint_before = batch.fused_plan_dispatches, cuda_kernel.joint_fit_launches
        t = time.perf_counter()
        drain()
        reopen_ms = 1e3 * (time.perf_counter() - t)
        reopen_fused = batch.fused_plan_dispatches - fused_before
        reopen_joint_fit = cuda_kernel.joint_fit_launches - joint_before
        phase_launches["i4"] = counters()
        phase_bindings["i4"] = bound()
    finally:
        kept.restore()
        stack.cluster.bind_pod = inner_bind
    if platform != "cpu":
        torch.cuda.synchronize()
    wall = time.monotonic() - t0
    final = bound()
    # Invariants.
    violations = []
    for t, name, node in binds:
        in_force = [f for ft, f in fence_log if ft <= t]
        if in_force and node in in_force[-1]:
            violations.append((name, node))
    members: dict[str, list] = {}
    for name, node in final.items():
        g = gang_of(name)
        if g:
            members.setdefault(g, []).append(node)
    split = {}
    for g, nodes in members.items():
        n = sum(x is not None for x in nodes)
        eff = stack.gang.effective_size(g)
        kind, size_g = gangs[g]
        lo = size_g // 2 if kind == "elastic" else size_g
        if n and not lo <= n <= size_g:
            split[g] = n
        if n and eff is not None and n != eff:
            split[g] = (n, eff)
    live = {p.uid for p in stack.cluster.list_pods()}
    leaked = sorted(stack.accountant.claimed_uids() - live)
    held = kept.errors()
    unbound = sorted(n for n, v in final.items() if v is None)
    return dict(
        platform=platform, pods=len(names), bindings=final, phase_bindings=phase_bindings,
        passes=[{k: v for k, v in p.items() if k not in ("ms", "start", "durations_ms",
                                                          "rebind_ms")} for p in passes],
        pass_ms={p["step"]: p["ms"] for p in passes},
        durations_ms={p["step"]: p["durations_ms"] for p in passes},
        rebind_ms={p["step"]: p["rebind_ms"] for p in passes if "rebind_ms" in p},
        flips=flips, stopped=len(stopped), down=len(down), flap=len(flap),
        event_states=event_states, ghost_left=ghost_left,
        drained=rb.drained, drain_moves=rb.moves, parked_after_requeue=parked,
        reopen_fused=reopen_fused, reopen_joint_fit=reopen_joint_fit,
        unbound=unbound, violations=violations, split=split, leaked=leaked,
        overcommitted=over_capacity(stack), accounting_gap=accounting_gap(stack),
        effective_el=stack.gang.effective_size("el"),
        launches=cuda_kernel.launches, joint_fit_launches=cuda_kernel.joint_fit_launches,
        row_update_launches=kernel_mod.row_update_launches,
        phase_launches={
            p: {k: c[k] - prev[k] for k in ("fleet_eval", "joint_fit")}
            for (p, c), prev in zip(phase_launches.items(),
                                    [base, *phase_launches.values()])
        },
        # The launches of the calls held against the plain versions.
        kept_launches=held["kept"], max_abs_err=held["max_abs_err"],
        **dispatch_health(batch),
        dispatch_count=batch.dispatch_count, serve_s=serve_s,
        serve_pods_per_s=size["serve"] / serve_s if serve_s else 0.0,
        rebalance_ms=rebalance_ms, reopen_ms=reopen_ms, wall_s=wall,
    )


NODEHEALTH_PARITY = ("bindings", "phase_bindings", "passes", "stopped", "down", "flap",
                     "event_states", "ghost_left", "drained", "drain_moves",
                     "parked_after_requeue", "reopen_fused", "unbound", "effective_el",
                     "dispatch_count")


def check_nodehealth_run(run: dict, size: dict) -> None:
    """The checks of one run (i) that need no second run."""
    name = f"run i ({run['platform']})"
    for key in ("violations", "split", "leaked", "overcommitted", "accounting_gap"):
        if run[key]:
            raise AssertionError(f"{name}: {key} {run[key]}")
    if demoted(run):
        raise AssertionError(f"{name}: {demoted(run)}")
    passes = {p["step"]: p for p in run["passes"]}
    empty = dict(patched=[], shrunk=[], requeued=[], deferred=[], singles=[],
                 durations_ms=[])
    if passes["i1 suspect"]["report"] != empty or passes["i1 flap"]["report"] != empty:
        raise AssertionError(f"{name}: the suspect or flap pass repaired: "
                             f"{passes['i1 suspect']['report']}, {passes['i1 flap']['report']}")
    if len(passes["i1 suspect"]["fenced"]) != size["stop"]:
        raise AssertionError(f"{name}: {len(passes['i1 suspect']['fenced'])} fenced")
    if len(passes["i1 flap"]["fenced"]) != run["down"]:
        raise AssertionError(f"{name}: the flapped hosts stayed fenced")
    rep = passes["i1 down"]["report"]
    plain = {f"p{j}" for j in range(2, size["plain"])}
    topo = {f"t{t:02d}" for t in range(size["topo"] // 2)}
    if (rep["shrunk"] != ["el"] or not plain <= set(rep["patched"])
            or set(rep["patched"]) | set(rep["requeued"]) != plain | topo
            or not rep["singles"]):
        raise AssertionError(f"{name}: the down pass repaired {rep}")
    flips = {f["step"]: f for f in run["flips"]}
    pure = flips["i1 probe"]
    if pure["restacks"] or pure["row_update_launches"] or pure["admission_patched"] != size["stop"]:
        raise AssertionError(f"{name}: the fence flip moved {pure}")
    if run["ghost_left"] or set(run["event_states"].values()) != {"down"}:
        raise AssertionError(f"{name}: ghost claims {run['ghost_left']}, "
                             f"states at event time {run['event_states']}")
    if run["drained"] != [f"t{size['topo'] - 2:02d}"]:
        raise AssertionError(f"{name}: the rebalancer drained {run['drained']}")
    if passes["i3 evacuate"]["report"]["patched"] != [f"p{size['plain'] - 2}"]:
        raise AssertionError(f"{name}: the deadline pass {passes['i3 evacuate']['report']}")
    if (passes["i4 down"]["report"]["requeued"] != ["p0", "p1"]
            or set(run["parked_after_requeue"].values()) != {0}):
        raise AssertionError(f"{name}: (i4) requeued {passes['i4 down']['report']}, "
                             f"bound after {run['parked_after_requeue']}")
    if not run["reopen_fused"]:
        raise AssertionError(f"{name}: the reopened gangs took no fused joint pass")
    lost_el = size["gang"] // 4
    if (run["effective_el"] != size["gang"] - lost_el
            or len(run["unbound"]) != lost_el
            or not all(n.startswith("el-") for n in run["unbound"])):
        raise AssertionError(f"{name}: unbound {run['unbound']}, el at {run['effective_el']}")


def check_nodehealth(g: dict, c: dict, size: dict) -> None:
    """Run (i) on the card against the same script on the CPU: every
    decision equal, every check of each run, the card run's kernels where
    they must launch and equal to their plain versions."""
    diff = [k for k in NODEHEALTH_PARITY if g[k] != c[k]]
    if diff:
        raise AssertionError(f"run i: cuda != cpu in {diff}")
    patched = [(f["step"], f["admission_patched"]) for f in g["flips"]]
    if patched != [(f["step"], f["admission_patched"]) for f in c["flips"]]:
        raise AssertionError("run i: admission rows patched differently on cuda and cpu")
    check_nodehealth_run(g, size)
    check_nodehealth_run(c, size)
    if c["launches"] or c["joint_fit_launches"] or c["row_update_launches"]:
        raise AssertionError("run i: the CPU run launched on the card")
    if not (g["phase_launches"]["i1"]["fleet_eval"] and g["reopen_joint_fit"]):
        raise AssertionError(f"run i: launches {g['phase_launches']}, "
                             f"joint_fit at the reopen {g['reopen_joint_fit']}")
    launched = {"fleet_eval": g["launches"], "joint_fit": g["joint_fit_launches"]}
    if g["kept_launches"] != launched:
        raise AssertionError(f"run i: {g['kept_launches']} launches held against the "
                             f"plain versions, {launched} launched")
    if g["max_abs_err"] != {"fleet_eval": 0, "joint_fit": 0}:
        raise AssertionError(f"run i: kernels differ from their plain versions: "
                             f"{g['max_abs_err']}")


def print_nodehealth(run: dict, smi: str) -> None:
    """Run (i)'s measurements, less its bindings, states and reports."""
    summary = {k: v for k, v in run.items()
               if k not in ("bindings", "phase_bindings", "passes")}
    summary["reports"] = {p["step"]: {k: v for k, v in p["report"].items() if v}
                          for p in run["passes"]}
    print(f"node health (i) {run['platform']} [{smi}]:", json.dumps(summary))


# Threads of the process that reruns run (h) on the CPU beside the card's
# phases: the card's are host-bound on one core, and the machine has eight.
CPU_RERUN_THREADS = 2


def cpu_rerun_child(conn, size: dict, nodehealth_size: "dict | None") -> None:
    """The body of the CPU rerun process: run (h)'s (h1)-(h3) and, given its
    size, run (i) on kernel_platform "cpu", sent back whole ({"h": ...,
    "i": ... or None}) or as the error that stopped them."""
    torch.set_num_threads(CPU_RERUN_THREADS)
    try:
        h = run_background("cpu", size, threaded=False)
        i = None if nodehealth_size is None else run_nodehealth("cpu", nodehealth_size)
        conn.send(("ok", {"h": h, "i": i}))
    except BaseException as e:  # noqa: BLE001 — the parent reports it
        conn.send(("error", f"{type(e).__name__}: {e}"))
    conn.close()


class CpuRerun:
    """The CPU runs of run (h) and, given ``nodehealth_size``, run (i) in a
    second process (spawned: the parent holds a CUDA context), started when
    the kernels are built so that it overlaps the card's phases instead of
    following them; :meth:`result` waits for it and returns run (h),
    :meth:`nodehealth` returns run (i), and :meth:`stop` ends the process
    if it still runs."""

    def __init__(self, size: dict = BACKGROUND_FULL,
                 nodehealth_size: "dict | None" = None) -> None:
        import multiprocessing

        ctx = multiprocessing.get_context("spawn")
        self._recv, send = ctx.Pipe(duplex=False)
        self._proc = ctx.Process(target=cpu_rerun_child,
                                 args=(send, size, nodehealth_size), daemon=True)
        self._proc.start()
        send.close()
        self._value: "dict | None" = None

    def _wait(self, timeout_s: float) -> dict:
        if self._value is None:
            if not self._recv.poll(timeout_s):
                raise TimeoutError(f"the CPU rerun sent nothing in {timeout_s} s")
            status, value = self._recv.recv()
            self._proc.join(timeout=30)
            if status != "ok":
                raise RuntimeError(f"the CPU rerun failed: {value}")
            self._value = value
        return self._value

    def result(self, timeout_s: float = 600.0) -> dict:
        return self._wait(timeout_s)["h"]

    def nodehealth(self, timeout_s: float = 600.0) -> "dict | None":
        return self._wait(timeout_s)["i"]

    def stop(self) -> None:
        if self._proc.is_alive():
            self._proc.terminate()
            self._proc.join(timeout=10)


def check_threaded_nospec(run: dict) -> None:
    """(h4) with the speculative cache off: the serve path's invariants,
    and no launch or plan from the cache."""
    name = "run h4 (speculation off)"
    if run["overcommitted"] or run["accounting_gap"]:
        raise AssertionError(f"{name}: over capacity {run['overcommitted']}, "
                             f"accounting != bound pods at {run['accounting_gap']}")
    if run["alive"] or run["errors"] or demoted(run):
        raise AssertionError(f"{name}: thread alive {run['alive']}, errors "
                             f"{run['errors']}, dispatch chain {demoted(run)}")
    if run["bound"] != run["pods"] or set(run["gangs"].values()) != {4}:
        raise AssertionError(f"{name}: {run['bound']}/{run['pods']} bound, gangs {run['gangs']}")
    if run["spec_launches"] or run["consumed"] or not run["serve_launches"]:
        raise AssertionError(f"{name}: {run['spec_launches']} speculation launches, "
                             f"{run['consumed']} plans consumed, {run['serve_launches']} "
                             f"serve launches")


Q9_KEYS = ("spec_enabled", "window_pods", "pick_check_failures", "burst_invalidated",
           "burst_dispatches", "burst_served", "serve_dispatches",
           "serve_dispatches_per_pod", "serve_launches", "serve_launches_per_pod",
           "consumed", "spec_launches", "pods_per_s", "p50_ms", "p99_ms", "wall_s")


def phase_background(smi: str, rerun: CpuRerun) -> dict:
    g = run_background("auto")
    c = rerun.result()
    print_background(g, smi)
    print_background(c, smi)
    check_background(g, c, BACKGROUND_FULL)
    # PERF.md section 7, Q9: the same (h4) window with speculation off.
    g["h4_nospec"] = run_threaded("auto", BACKGROUND_FULL, spec_enabled=False)
    check_threaded_nospec(g["h4_nospec"])
    for run in (g["h4"], g["h4_nospec"]):
        print(f"background (h4) serve-time checks [{smi}]:",
              json.dumps({k: run[k] for k in Q9_KEYS}))
    return g


def phase_nodehealth(smi: str, rerun: CpuRerun) -> dict:
    g = run_nodehealth("auto")
    c = rerun.nodehealth()
    print_nodehealth(g, smi)
    print_nodehealth(c, smi)
    check_nodehealth(g, c, NODEHEALTH_FULL)
    return g


# --- run (j): observability -------------------------------------------------

OBSERVABILITY_FULL = dict(slices=512, v5e_hosts=2952, spot=320, prod=8, pairs=1,
                          hold_s=3.0, scrapes=20)
OBSERVABILITY_SMALL = dict(slices=32, v5e_hosts=160, spot=272, prod=4, pairs=1,
                           hold_s=1.2, scrapes=3)
# Families whose values are wall-clock readings or name the device: their
# sample counts are compared, their values are not.
OBS_WALL = ("yoda_bind_wall_ms", "yoda_delta_apply_ms", "yoda_kernel_on_accelerator")
PHASES = ("prefilter", "spec", "filter", "score", "reserve", "permit", "postfilter",
          "total")
TRACE_DIR = "build"


def scrape_values(text: str) -> dict:
    """A /metrics page as {sample: value}, less the values of OBS_WALL
    families (their _count samples stay)."""
    out = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        sample, value = line.rsplit(" ", 1)
        name = sample.split("{", 1)[0]
        if name.startswith(OBS_WALL) and not name.endswith("_count"):
            continue
        out[sample] = float(value)
    return out


def span_shape(tracer) -> list:
    """The tracer's records as a sorted multiset of (subject, span, parent
    span, "" for a root). Inline ``bind`` spans pass a wall-time gate, so
    they are left out."""
    recs = tracer.records()
    by_id = {r.span_id: r for r in recs}
    counts: dict = {}
    for r in recs:
        if r.name == "bind":
            continue
        parent = by_id[r.parent_id].name if r.parent_id in by_id else ""
        key = (r.subject, r.name, parent)
        counts[key] = counts.get(key, 0) + 1
    return sorted([*k, n] for k, n in counts.items())


def no_wall(obj):
    """A why-pending record without its wall-clock stamps."""
    if isinstance(obj, dict):
        return {k: no_wall(v) for k, v in obj.items() if not k.endswith("_wall_unix")}
    if isinstance(obj, list):
        return [no_wall(v) for v in obj]
    return obj


def pending_view(pending) -> dict:
    summary = no_wall(pending.summary())
    summary["pending"].sort(key=lambda row: row["key"])
    return {"summary": summary,
            "explain": {row["key"]: no_wall(pending.explain(row["key"]))
                        for row in summary["pending"]}}


class KeptKernels:
    """While installed (or entered), every ``fleet_eval`` / ``joint_fit``
    call on the card keeps its inputs and result, to be held against the
    plain versions (:meth:`errors`), and the name of the thread that
    launched it (``threads``); the launch counts are zeroed on install."""

    def __enter__(self):
        self.install()
        return self

    def __exit__(self, *exc):
        self.restore()
        return False

    def install(self) -> None:
        from yoda_tpu_torch.ops import cuda_kernel

        self.mod = cuda_kernel
        self.fleet, self.joint = [], []
        self.threads: set = set()
        self.real = (cuda_kernel.fleet_eval, cuda_kernel.joint_fit)
        real_fleet, real_joint = self.real

        def fleet_eval(chips, nodes, dyn, host_ok, reqs, weights, out=None, counter=None):
            got = real_fleet(chips, nodes, dyn, host_ok, reqs, weights, out=out,
                             counter=counter)
            if chips.is_cuda:
                self.fleet.append((tuple(t.clone() for t in (chips, nodes, dyn, host_ok,
                                                              reqs)), weights, got.clone()))
                self.threads.add(threading.current_thread().name)
            return got

        def joint_fit(packed, chips_k, starts_k, valid_k, out=None, counter=None):
            got = real_joint(packed, chips_k, starts_k, valid_k, out=out, counter=counter)
            if packed.is_cuda:
                self.joint.append((tuple(t.clone() for t in (packed, chips_k, starts_k,
                                                             valid_k)),
                                   tuple(t.clone() for t in got)))
                self.threads.add(threading.current_thread().name)
            return got

        cuda_kernel.fleet_eval, cuda_kernel.joint_fit = fleet_eval, joint_fit
        cuda_kernel.launches = cuda_kernel.joint_fit_launches = 0

    def restore(self) -> None:
        self.mod.fleet_eval, self.mod.joint_fit = self.real
        self.launches = {"fleet_eval": self.mod.launches,
                         "joint_fit": self.mod.joint_fit_launches}

    def errors(self) -> dict:
        """Launches made, launches held against the plain versions and the
        largest difference, per kernel."""
        from yoda_tpu_torch.ops import kernel as kernel_mod

        err = {"fleet_eval": 0, "joint_fit": 0}
        for args, weights, got in self.fleet:
            want = kernel_mod.kernel_packed_burst(*(a.cpu() for a in args), weights)
            err["fleet_eval"] = max(err["fleet_eval"], abs_err(got, want))
        for (packed, chips_k, starts_k, valid_k), got in self.joint:
            p = packed.cpu()
            want = kernel_mod.joint_fit_scan(p[:, 0], p[:, 3], p[:, 5], chips_k.cpu(),
                                             starts_k.cpu(), valid_k.cpu())
            for g_t, w_t in zip(got, want):
                err["joint_fit"] = max(err["joint_fit"], abs_err(g_t, w_t))
        kept = {"fleet_eval": sum(-(-args[4].shape[0] // self.mod.MAX_REQUESTS)
                                  for args, _, _ in self.fleet),
                "joint_fit": len(self.joint)}
        return {"launches": self.launches, "kept": kept, "max_abs_err": err}


def obs_script():
    """Run (j1)'s pods: run (b)'s 256 singletons, then run (c)'s two gang
    waves (plain, coscheduling, topology and multislice gangs with 64
    singletons)."""
    from yoda_tpu_torch.api.types import PodSpec

    waves, gangs = gang_script(seed=1)
    singles = [PodSpec(n, labels=dict(l)) for n, l in fleet_and_pods(0)[1]]
    gang_waves = [[PodSpec(n, labels=dict(l)) for n, l, _ in w] for w in waves]
    return singles, gang_waves, gangs


def obs_reload(stack):
    """Run (j4)'s mid-serve reload: four reloadable knobs and one immutable
    knob change; returns the reloader's report and the live values."""
    from yoda_tpu_torch.config import SchedulerConfig
    from yoda_tpu_torch.overload import ConfigReloader, LiveConfig
    from yoda_tpu_torch.standalone import apply_reloadable

    base = SchedulerConfig(kernel_platform=stack.batch.platform, batch_requests=16)
    live = LiveConfig(base)
    candidate = dataclasses.replace(
        base, trace_sample_rate=0.5, spec_cache_size=8, rebalance_max_moves=2,
        overload_queue_high=5000, scheduler_name="renamed-scheduler",
    )
    report = ConfigReloader(lambda: candidate, live,
                            lambda cfg: apply_reloadable([stack], cfg)).reload()
    m = stack.metrics
    values = dict(
        trace_sample_rate=m.tracer.sample_rate, spec_cache_size=stack.speculation.size,
        rebalance_max_moves=stack.rebalancer.max_moves,
        overload_queue_high=m.overload.queue_high,
        scheduler_name=live.current.scheduler_name, generation=live.generation,
    )
    return {"report": report, "live": values}


def run_obs_serve(platform: str, size: dict, *, stepped: bool = True,
                  scrape: bool = False) -> dict:
    """Run (j1) on one kernel_platform: run (b)'s singletons at K = 16, then
    run (c)'s two gang waves, with observability at its defaults. With
    ``stepped`` the scheduling clock moves only between steps (so both
    platforms observe the same phase histogram, SLO windows and spans) and
    the mid-serve reload of (j4) runs between the gang waves; without it
    the run is on the wall clock, for the phase times, the Perfetto trace,
    the dispatch spans against the device time inside them and (with
    ``scrape``) every endpoint fetched from a thread during the run and
    again after it."""
    import urllib.request

    from yoda_tpu_torch.metrics_server import MetricsServer

    clock = SteppedClock(10_000.0) if stepped else None
    stack, _agent = build_fleet(platform, 16, slices=size["slices"],
                                v5e_hosts=size["v5e_hosts"],
                                **({"clock": clock} if stepped else {}))
    m = stack.metrics
    stack.reconciler.resync()
    singles, gang_waves, gangs = obs_script()
    dispatch_calls: list = []  # (host t0, host t1, CUDA-event ms) per gang dispatch
    if platform != "cpu" and not stepped:
        kern = stack.batch._kern

        def evented(inner):
            def call(*args, **kw):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                t0 = time.monotonic()
                start.record()
                try:
                    return inner(*args, **kw)
                finally:
                    end.record()
                    end.synchronize()
                    dispatch_calls.append((t0, time.monotonic(), start.elapsed_time(end)))
            return call

        kern.evaluate_joint_plan = evented(kern.evaluate_joint_plan)
        kern.evaluate_joint = evented(kern.evaluate_joint)
    server = stop = scraper = None
    fetched: dict = {}
    errors: list = []
    endpoints = ("/metrics", "/healthz", "/readyz", "/trace?n=20",
                 "/debug/traces?n=50", "/debug/traces?n=50&format=perfetto",
                 "/debug/pending", "/debug/slo", "/debug/journal", "/debug/shards")
    if scrape:
        server = MetricsServer(m, host="127.0.0.1", port=0)
        server.start()
        base = f"http://127.0.0.1:{server.port}"
        stop = threading.Event()

        def scrape_loop():
            # One round of every endpoint a second: an unpaced loop would
            # take the interpreter lock from the serve loop it watches
            # (a /metrics scrape walks the 5,000-node fleet in Python).
            try:
                while not stop.wait(1.0):
                    for path in endpoints:
                        with urllib.request.urlopen(base + path, timeout=30) as r:
                            fetched[path] = fetched.get(path, 0) + (r.status == 200)
            except Exception as e:  # noqa: BLE001 — reported by the checks
                errors.append(f"{type(e).__name__}: {e}")

        scraper = threading.Thread(target=scrape_loop, name="scraper", daemon=True)
        scraper.start()
    out: dict = {"platform": platform, "stepped": stepped}
    t0 = time.monotonic()
    with KeptKernels() as kept:
        for i, pod in enumerate(singles):
            stack.cluster.create_pod(pod)
            if clock is not None:
                clock.advance(0.01)
        stack.scheduler.run_until_idle(max_wall_s=600)
        for w, wave in enumerate(gang_waves):
            if clock is not None:
                clock.advance(5.0)
            for pod in wave:
                stack.cluster.create_pod(pod)
                if clock is not None:
                    clock.advance(0.01)
            stack.scheduler.run_until_idle(max_wall_s=600)
            if w == 0 and stepped:
                out["reload"] = obs_reload(stack)
        if platform != "cpu":
            torch.cuda.synchronize()
    out["wall_s"] = time.monotonic() - t0
    if clock is not None:
        clock.advance(30.0)
    if scrape:
        stop.set()
        scraper.join(timeout=60)
        after, times = {}, []
        for path in endpoints:
            with urllib.request.urlopen(base + path, timeout=30) as r:
                after[path] = r.status
        key = next(row["key"] for row in m.pending.summary()["pending"]) \
            if m.pending.summary()["pending"] else None
        if key is not None:
            with urllib.request.urlopen(f"{base}/debug/pending/{key}", timeout=30) as r:
                after["/debug/pending/<key>"] = r.status
        for _ in range(size["scrapes"]):
            t = time.perf_counter()
            with urllib.request.urlopen(base + "/metrics", timeout=30) as r:
                r.read()
            times.append(1e3 * (time.perf_counter() - t))
        t = time.perf_counter()
        for _ in range(size["scrapes"]):
            m.binpack_efficiency.value()
        chips_ms = 1e3 * (time.perf_counter() - t) / size["scrapes"]
        t = time.perf_counter()
        m.slo.cache_ttl_s = 0.0
        m.slo.evaluate()
        slo_ms = 1e3 * (time.perf_counter() - t)
        server.stop()
        out["scrape"] = dict(during=fetched, after=after, errors=errors,
                             metrics_ms_median=statistics.median(times),
                             metrics_ms=times, binpack_gauge_ms=chips_ms,
                             slo_evaluate_ms=slo_ms)
    names = [p.name for p in singles] + [p.name for w in gang_waves for p in w]
    bound = bindings_of(stack, names)
    out.update(
        pods=len(names), bound=sum(v not in (None, "evicted") for v in bound.values()),
        bindings=bound, overcommitted=over_capacity(stack),
        accounting_gap=accounting_gap(stack),
        waiting=len(stack.framework.waiting_pods()),
        **dispatch_health(stack.batch),
        gangs={g: sum(bound[n] not in (None, "evicted") for n in names
                      if n.startswith(f"{g}-")) for g in gangs},
        **kept.errors(),
    )
    if stepped:
        out.update(
            metrics=scrape_values(m.registry.render_prometheus()),
            phases={ph: m.latency.count(phase=ph) for ph in PHASES},
            pending=pending_view(m.pending),
            slo=m.slo.evaluate(now=clock()),
            spans=span_shape(m.tracer),
            traces=len(m.recent_traces(100_000)),
        )
    else:
        recs = m.tracer.records()
        tracks: dict = {}
        for r in recs:
            tracks[r.track] = tracks.get(r.track, 0) + 1
        spans = [(r.t0_ms / 1e3, (r.t0_ms + r.dur_ms) / 1e3, r.name) for r in recs
                 if r.name in ("gang-dispatch", "joint-dispatch")]
        uncovered = []
        for s0, s1, name in {(s0, s1, n) for s0, s1, n in spans}:
            inside = [c for c in dispatch_calls if s0 <= c[0] and c[1] <= s1]
            if platform != "cpu" and (not inside
                                      or (s1 - s0) * 1e3 < sum(c[2] for c in inside)):
                uncovered.append((name, (s1 - s0) * 1e3, [c[2] for c in inside]))
        import os

        os.makedirs(TRACE_DIR, exist_ok=True)
        path = os.path.join(TRACE_DIR, f"trace_run_j_{platform}.json")
        with open(path, "w") as f:
            json.dump(m.tracer.to_perfetto(recs), f)
        out.update(
            phase_ms={ph: {"count": m.latency.count(phase=ph),
                           "p50": 1e3 * m.latency.quantile(0.5, phase=ph),
                           "p99": 1e3 * m.latency.quantile(0.99, phase=ph)}
                      for ph in PHASES},
            spans_per_track=tracks, span_records=len(recs), perfetto=path,
            dispatch_spans=len({(s0, s1) for s0, s1, _ in spans}),
            dispatch_event_ms=[c[2] for c in dispatch_calls],
            dispatch_uncovered=uncovered,
            pods_per_s=out["bound"] / out["wall_s"] if out["wall_s"] else 0.0,
        )
    return out


def run_obs_ladder(platform: str, size: dict) -> dict:
    """Run (j2) on one kernel_platform: the overload ladder driven by queue
    depth (``overload_queue_high`` 64, the cycle signal off) on a stepped
    clock. A spot gang's first member parks at Permit, ``size["spot"]``
    spot singletons (priority 0, below ``overload_shed_priority``) queue,
    three evaluations climb to SHED; the gang's second member and
    ``size["prod"]`` prod pods (priority 100; fewer than the BROWNOUT
    bucket's 10 tokens, which SHED keeps applying) arrive and the queue
    drains;
    then the clock steps 10 s per evaluation until the ladder is NOMINAL
    and the queue empty. Each step records the level, the gates, the
    tracer's rate, the parks and the bindings."""
    from yoda_tpu_torch.api.types import PodSpec

    clock = SteppedClock(20_000.0)
    stack, _agent = build_fleet(platform, 16, slices=size["slices"],
                                v5e_hosts=size["v5e_hosts"], clock=clock,
                                overload_queue_high=64, overload_cycle_ms_high=0,
                                bind_workers=0)
    m, ov, q = stack.metrics, stack.metrics.overload, stack.queue
    stack.reconciler.resync()
    steps: list = []

    def step(tag: str) -> None:
        pods = stack.cluster.list_pods()
        steps.append(dict(
            tag=tag, level=ov.level, transitions=ov.transitions,
            pressure=round(ov.last_pressure, 6), shed_total=ov.shed_total,
            shed_parks=q.shed_parks, quota_parks=q.quota_parks,
            sample_rate=m.tracer.sample_rate, rebalancer_gate=stack.rebalancer.gate_fn(),
            nodehealth_gate=stack.nodehealth.gate_fn(), depth=q.overload_depth(),
            bound=sorted(p.name for p in pods if p.node_name),
            pending=m.pending.summary()["by_kind"],
        ))

    spot_gang = {"tpu/gang": "spotg", "tpu/gang-size": "2", "tpu/chips": "8",
                 "tpu/generation": "v5e", "tpu/priority": "0"}
    with KeptKernels() as kept:
        step("start")
        stack.cluster.create_pod(PodSpec("spotg-0", labels=dict(spot_gang)))
        stack.scheduler.run_until_idle(max_wall_s=1.0)
        for i in range(size["spot"]):
            stack.cluster.create_pod(PodSpec(
                f"spot-{i:03d}", labels={"tpu/chips": "1", "tpu/priority": "0"}))
        for _ in range(3):
            clock.advance(1.0)
            ov.evaluate()
            step("climb")
        stack.cluster.create_pod(PodSpec("spotg-1", labels=dict(spot_gang)))
        for i in range(size["prod"]):
            stack.cluster.create_pod(PodSpec(
                f"prod-{i:02d}", labels={"tpu/chips": "2", "tpu/priority": "100"}))
        # Every drain runs to its end (no Permit waiter is left after the
        # gang's second member binds): a drain cut by wall time would leave
        # queued pods that push the ladder back up on a slow host.
        stack.scheduler.run_until_idle(max_wall_s=600)
        step("shed")
        for _ in range(12):
            clock.advance(10.0)
            ov.evaluate()
            stack.scheduler.run_until_idle(max_wall_s=600)
            step("down")
            if ov.level == "NOMINAL" and not len(q):
                break
        if platform != "cpu":
            torch.cuda.synchronize()
    names = (["spotg-0", "spotg-1"] + [f"spot-{i:03d}" for i in range(size["spot"])]
             + [f"prod-{i:02d}" for i in range(size["prod"])])
    return dict(
        platform=platform, steps=steps, pods=len(names),
        bindings=bindings_of(stack, names), overcommitted=over_capacity(stack),
        accounting_gap=accounting_gap(stack), **dispatch_health(stack.batch),
        **kept.errors(),
    )


def run_obs_cycle_signal(platform: str, size: dict) -> dict:
    """Run (j3), reported and not compared: the ladder's own
    ``run_forever`` at the default 1 s period and 250 ms cycle threshold on
    a thread of its own, beside a K = 1 serve of run (a)'s pods on the
    wall clock, then ``size["hold_s"]`` more seconds of ladder. Returns
    the ``total`` p50/p99, every transition and the seconds at each
    level."""
    from yoda_tpu_torch.api.types import PodSpec

    stack, _agent = build_fleet(platform, 1, slices=size["slices"],
                                v5e_hosts=size["v5e_hosts"])
    m, ov = stack.metrics, stack.metrics.overload
    stack.reconciler.resync()
    t_start = time.monotonic()
    changes = [(0.0, ov.level, 0.0)]
    evaluations: list = []
    real_transition, real_evaluate = ov._transition_locked, ov.evaluate

    def noted_transition(new_idx):
        real_transition(new_idx)
        changes.append((time.monotonic() - t_start, ov.level, ov.last_pressure))

    def noted_evaluate(now=None):
        sig = ov.pressure()  # what the evaluation reads: it marks the cycles seen
        level = real_evaluate(now)
        evaluations.append(dict(at_s=round(time.monotonic() - t_start, 3), level=level,
                                cycle_p99_ms=1e3 * m.latency.quantile(0.99, phase="total"),
                                signals={k: round(v, 4) for k, v in sig.items()}))
        return level

    ov._transition_locked, ov.evaluate = noted_transition, noted_evaluate
    stop = threading.Event()
    ladder = threading.Thread(target=ov.run_forever, args=(stop,), name="overload",
                              daemon=True)
    ladder.start()
    with KeptKernels() as kept:
        for name, labels in fleet_and_pods(0)[0]:
            stack.cluster.create_pod(PodSpec(name, labels=dict(labels)))
        stack.scheduler.run_until_idle(max_wall_s=600)
        if platform != "cpu":
            torch.cuda.synchronize()
        serve_s = time.monotonic() - t_start
        time.sleep(size["hold_s"])
    stop.set()
    ladder.join(timeout=10)
    end = time.monotonic() - t_start
    at_level: dict = {}
    for (t, level, _p), nxt in zip(changes, [*changes[1:], (end, None, None)]):
        at_level[level] = at_level.get(level, 0.0) + nxt[0] - t
    return dict(
        platform=platform, serve_s=serve_s, wall_s=end, alive=ladder.is_alive(),
        total_p50_ms=1e3 * m.latency.quantile(0.5, phase="total"),
        total_p99_ms=1e3 * m.latency.quantile(0.99, phase="total"),
        cycles=m.latency.count(phase="total"), transitions=changes,
        seconds_at_level=at_level, evaluations=evaluations,
        repairs_paused_at_end=ov.repairs_paused(), sample_rate_at_end=m.tracer.sample_rate,
        first_restack_ms=stack.batch._resident.last_restack_ms
        if stack.batch._resident is not None else None,
        bound=sum(1 for p in stack.cluster.list_pods() if p.node_name),
        **kept.errors(),
    )


def run_trace_cost(platform: str, size: dict) -> dict:
    """Tracing's cost, reported and not claimed: run (b) (256 singletons at
    K = 16 on a fresh stack) in ``size["pairs"]`` alternating pairs,
    ``trace_sample_rate`` 1.0 then 0, on the wall clock: pods/s and p99
    per run and their medians and spreads per side."""
    from yoda_tpu_torch.api.types import PodSpec

    runs: dict = {1.0: [], 0.0: []}
    with KeptKernels() as kept:
        for _pair in range(size["pairs"]):
            for rate in (1.0, 0.0):
                stack, _agent = build_fleet(platform, 16, slices=size["slices"],
                                            v5e_hosts=size["v5e_hosts"],
                                            trace_sample_rate=rate)
                names = []
                for name, labels in fleet_and_pods(0)[1]:
                    stack.cluster.create_pod(PodSpec(name, labels=dict(labels)))
                    names.append(name)
                t0 = time.monotonic()
                stack.scheduler.run_until_idle(max_wall_s=600)
                if platform != "cpu":
                    torch.cuda.synchronize()
                wall = time.monotonic() - t0
                lat = singleton_latencies(stack, names)
                runs[rate].append(dict(pods_per_s=len(lat) / wall if wall else 0.0,
                                       p99_ms=pct_ms(lat, 0.99),
                                       spans=len(stack.metrics.tracer.records())))

    def side(rows):
        pps = [r["pods_per_s"] for r in rows]
        p99 = [r["p99_ms"] for r in rows]
        return dict(pods_per_s_median=statistics.median(pps),
                    pods_per_s_range=[min(pps), max(pps)],
                    p99_ms_median=statistics.median(p99), p99_ms_range=[min(p99), max(p99)],
                    spans=[r["spans"] for r in rows], runs=rows)

    return dict(platform=platform, pairs=size["pairs"], traced=side(runs[1.0]),
                untraced=side(runs[0.0]), **kept.errors())


def run_observability(platform: str, size: dict = OBSERVABILITY_FULL, *,
                      reported: bool = True) -> dict:
    """Run (j) on one kernel_platform: (j1) and (j2), compared across
    platforms, and with ``reported`` the measured parts: (j1) on the wall
    clock with the endpoints scraped during and after it ((j4)), (j3) and
    tracing's cost."""
    parts = {"j1": lambda: run_obs_serve(platform, size),
             "j2": lambda: run_obs_ladder(platform, size)}
    if reported:
        parts.update(
            j1_wall=lambda: run_obs_serve(platform, size, stepped=False, scrape=True),
            j3=lambda: run_obs_cycle_signal(platform, size),
            cost=lambda: run_trace_cost(platform, size),
        )
    out: dict = {}
    for part, fn in parts.items():
        t = time.monotonic()
        out[part] = fn()
        out[part]["part_s"] = time.monotonic() - t
    return out


OBS_PARITY = {
    "j1": ("bindings", "metrics", "phases", "pending", "slo", "spans", "traces", "reload"),
    "j2": ("steps", "bindings"),
}


def check_observability_run(run: dict, size: dict) -> None:
    """The checks each platform's run (j) must pass on its own."""
    from yoda_tpu_torch.config import SchedulerConfig

    name = f"run j ({run['j1']['platform']})"
    full = size is OBSERVABILITY_FULL
    parts = [p for p in ("j1", "j1_wall", "j2", "j3", "cost") if p in run]
    for part in parts:
        r = run[part]
        if r.get("overcommitted") or r.get("accounting_gap") or demoted(r):
            raise AssertionError(f"{name} {part}: over capacity {r.get('overcommitted')}, "
                                 f"accounting {r.get('accounting_gap')}, dispatch chain "
                                 f"{demoted(r)}")
        if r["kept"] != r["launches"] or any(r["max_abs_err"].values()):
            raise AssertionError(f"{name} {part}: {r['kept']} launches held against the "
                                 f"plain versions of {r['launches']}, differences "
                                 f"{r['max_abs_err']}")
    j1 = run["j1"]
    if j1["waiting"] or (full and j1["bound"] != j1["pods"]):
        raise AssertionError(f"{name} j1: {j1['bound']}/{j1['pods']} bound, "
                             f"{j1['waiting']} waiting")
    if any(n and n != gang_size for n, gang_size in
           ((j1["gangs"][g], obs_script()[2][g][1]) for g in j1["gangs"])):
        raise AssertionError(f"{name} j1: split gang {j1['gangs']}")
    if not (j1["phases"]["total"] and j1["phases"]["filter"] and j1["phases"]["permit"]):
        raise AssertionError(f"{name} j1: phase histogram {j1['phases']}")
    kinds = {s[1] for s in j1["spans"]}
    want = {"enqueue", "cycle", "permit-park", "bound", "gather", "gang-release",
            "gang-dispatch" if not full else "joint-dispatch", "resync"}
    if not want <= kinds:
        raise AssertionError(f"{name} j1: spans {sorted(kinds)} lack {sorted(want - kinds)}")
    rep = j1["reload"]
    if (rep["report"]["applied"] != ["overload_queue_high", "rebalance_max_moves",
                                     "spec_cache_size", "trace_sample_rate"]
            or rep["report"]["immutable"] != ["scheduler_name"]
            or rep["live"]["trace_sample_rate"] != 0.5
            or rep["live"]["scheduler_name"] != SchedulerConfig().scheduler_name):
        raise AssertionError(f"{name} j4 reload: {rep}")
    steps = run["j2"]["steps"]
    levels = [s["level"] for s in steps]
    if levels[:4] != ["NOMINAL", "ELEVATED", "BROWNOUT", "SHED"] or levels[-1] != "NOMINAL":
        raise AssertionError(f"{name} j2: levels {levels}")
    elevated = steps[1]
    if elevated["sample_rate"] != 0.0 or elevated["rebalancer_gate"] \
            or elevated["nodehealth_gate"]:
        raise AssertionError(f"{name} j2: ELEVATED did not pause the features {elevated}")
    shed = next(s for s in steps if s["tag"] == "shed")
    prod = {f"prod-{i:02d}" for i in range(size["prod"])}
    if not prod <= set(shed["bound"]) or not {"spotg-0", "spotg-1"} <= set(shed["bound"]) \
            or any(n.startswith("spot-") for n in shed["bound"]) \
            or shed["pending"].get("overload-shed") != size["spot"]:
        raise AssertionError(f"{name} j2: SHED {shed['pending']}, bound "
                             f"{len(shed['bound'])}")
    prev = shed
    for s in steps[steps.index(shed) + 1:]:
        if s["level"] == "BROWNOUT" and prev["level"] != "NOMINAL":
            if len(s["bound"]) - len(prev["bound"]) > 10 or not s["quota_parks"]:
                raise AssertionError(f"{name} j2: BROWNOUT admitted "
                                     f"{len(s['bound']) - len(prev['bound'])}, quota parks "
                                     f"{s['quota_parks']}")
        prev = s
    final = steps[-1]
    if final["sample_rate"] != 1.0 or not final["rebalancer_gate"] \
            or len(final["bound"]) != run["j2"]["pods"]:
        raise AssertionError(f"{name} j2: after the step-down {final['sample_rate']}, "
                             f"{len(final['bound'])}/{run['j2']['pods']} bound")
    if "j1_wall" in run:
        w = run["j1_wall"]
        sc = w["scrape"]
        if sc["errors"] or any(v != 200 for v in sc["after"].values()) \
                or set(sc["after"]) - {"/debug/pending/<key>"} != set(sc["during"]):
            raise AssertionError(f"{name} j4 scrapes: {sc['errors']} {sc['after']} "
                                 f"{sc['during']}")
        if w["dispatch_uncovered"] or not w["dispatch_spans"]:
            raise AssertionError(f"{name} j1: dispatch spans {w['dispatch_spans']}, not "
                                 f"covering their device time {w['dispatch_uncovered']}")
        j3 = run["j3"]
        if j3["alive"] or j3["bound"] != 64 or not j3["evaluations"]:
            raise AssertionError(f"{name} j3: ladder alive {j3['alive']}, bound "
                                 f"{j3['bound']}, evaluations {len(j3['evaluations'])}")


def check_observability(g: dict, c: dict, size: dict) -> None:
    """Run (j) on the card against the same script on the CPU."""
    diff = [f"{part}.{k}" for part, keys in OBS_PARITY.items() for k in keys
            if g[part][k] != c[part][k]]
    if diff:
        raise AssertionError(f"run j: cuda != cpu in {diff}")
    check_observability_run(g, size)
    check_observability_run(c, size)
    for part in OBS_PARITY:
        if any(c[part]["launches"].values()):
            raise AssertionError(f"run j {part}: the CPU run launched on the card")
        if not g[part]["launches"]["fleet_eval"]:
            raise AssertionError(f"run j {part}: no fleet_eval launch on the card")
    if not g["j1"]["launches"]["joint_fit"]:
        raise AssertionError("run j1: no joint_fit launch on the card")


def print_observability(run: dict, smi: str) -> None:
    """Run (j)'s measurements, less its bindings, samples and spans."""
    summary = {}
    for part, r in run.items():
        summary[part] = {k: v for k, v in r.items()
                         if k not in ("bindings", "metrics", "pending", "spans", "steps",
                                      "slo", "transitions", "evaluations")}
        if part == "j2":
            summary[part]["levels"] = [(s["tag"], s["level"], len(s["bound"]),
                                        s["quota_parks"], s["shed_parks"])
                                       for s in r["steps"]]
        if part == "j3":
            summary[part]["transitions"] = r["transitions"]
            summary[part]["evaluations"] = r["evaluations"][:12]
    print(f"observability (j) {run['j1']['platform']} [{smi}]:", json.dumps(summary))


def rerun_child(conn, run: str, size: dict) -> None:
    """The body of a CPU rerun process: ``run`` (a run function of this
    script) on kernel_platform "cpu" without its reported parts, sent back
    whole or as the error."""
    torch.set_num_threads(CPU_RERUN_THREADS)
    try:
        conn.send(("ok", globals()[run]("cpu", size, reported=False)))
    except BaseException as e:  # noqa: BLE001 — the parent reports it
        conn.send(("error", f"{type(e).__name__}: {e}"))
    conn.close()


class SpawnedRerun:
    """One run's CPU run in a process of its own (spawned, like
    :class:`CpuRerun`): runs (j) and (k), each started when the kernels
    are built so that it overlaps the card's phases; :meth:`result` waits
    for it."""

    def __init__(self, run: str, size: dict, what: str, *, daemon: bool = True) -> None:
        import multiprocessing

        self.what = what
        ctx = multiprocessing.get_context("spawn")
        self._recv, send = ctx.Pipe(duplex=False)
        # A run that spawns processes of its own (run (r2)'s API servers)
        # needs a process that may have children: not a daemon.
        self._proc = ctx.Process(target=rerun_child, args=(send, run, size), daemon=daemon)
        self._proc.start()
        send.close()

    def result(self, timeout_s: float = 900.0) -> dict:
        if not self._recv.poll(timeout_s):
            raise TimeoutError(f"{self.what}'s CPU rerun sent nothing in {timeout_s} s")
        status, value = self._recv.recv()
        self._proc.join(timeout=30)
        if status != "ok":
            raise RuntimeError(f"{self.what}'s CPU rerun failed: {value}")
        return value

    def stop(self) -> None:
        if self._proc.is_alive():
            self._proc.terminate()
            self._proc.join(timeout=10)


def phase_observability(smi: str, rerun: SpawnedRerun) -> dict:
    g = run_observability("auto")
    c = rerun.result()
    print_observability(g, smi)
    print_observability(c, smi)
    check_observability(g, c, OBSERVABILITY_FULL)
    return g


# --- run (k): the shipped ConfigMap -----------------------------------------

CONFIGMAP_PATH = "deploy/yoda-tpu-scheduler.yaml"
TEAMS = ("team-a", "team-b", "team-c")
# The full fleet, with the traffic's depth cut to fit the phase: every
# launch is held against its plain version on the host (~8 ms a K = 1
# call at 8,192 rows) beside ~28 ms a K = 1 cycle, so the flood is 256
# pods (not 2,048), each light tenant 16 singletons and 2 gangs (not 64
# and 4), and 16 turns a step (not 64). The quota (512 at the full depth)
# is 128: under it fits each light tenant's whole ask (at most 16 x 4 +
# 2 x 8 x 4 chips), and 4 deletions a step (not 32) let the flood's bound
# chips reach it.
TENANCY_FULL = dict(slices=512, v5e_hosts=2952, flood=256, singles=16, gangs=2,
                    gang_size=8, republish=256, deletes=4, turns=16, quota=128,
                    quota_steps=32, publish_period_s=10.0, rollout_at_s=2.0,
                    rollout_s=1.0)
TENANCY_SMALL = dict(slices=16, v5e_hosts=96, flood=128, singles=8, gangs=1,
                     gang_size=4, republish=16, deletes=4, turns=8, quota=48,
                     quota_steps=24, publish_period_s=1.0, rollout_at_s=0.2,
                     rollout_s=0.2)
# Families whose samples follow the ingest drain thread's timing (where the
# batch boundaries fall): compared on the stepped runs less these.
INGEST_TIMED = ("yoda_ingest_batch_size",)


def _yaml_scalar(text: str):
    if text in ("true", "false"):
        return text == "true"
    if text in ("null", "~"):
        return None
    if len(text) > 1 and text[0] in "'\"" and text[-1] == text[0]:
        return text[1:-1]
    for cast in (int, float):
        try:
            return cast(text)
        except ValueError:
            pass
    return text


def configmap_config(path: str = CONFIGMAP_PATH) -> dict:
    """The scheduler config the shipped ConfigMap carries under its
    ``config.yaml`` key, read with a parser for the block mappings,
    scalars and comments it is written in (no YAML package is needed on
    the card's machine; tests/test_torch_tenancy.py holds this equal to
    ``yaml.safe_load``)."""
    lines = open(path).read().splitlines()
    start = next(i for i, line in enumerate(lines) if line.strip() == "config.yaml: |")
    base = len(lines[start]) - len(lines[start].lstrip())
    root: dict = {}
    parents = [(base, root)]
    for line in lines[start + 1:]:
        body = "" if line.lstrip().startswith("#") else line.split(" #", 1)[0].rstrip()
        if not body.strip():
            continue
        indent = len(body) - len(body.lstrip())
        if indent <= base:
            break
        key, _, value = body.strip().partition(":")
        while parents[-1][0] >= indent:
            parents.pop()
        value = value.strip()
        if value:
            parents[-1][1][key] = _yaml_scalar(value)
        else:
            parents[-1][1][key] = {}
            parents.append((indent, parents[-1][1][key]))
    return root


def tenancy_script(size: dict, seed: int = 11):
    """Run (k)'s pods as (name, namespace, labels): the flood's one-chip
    singletons, and the three light tenants' pods in a seeded order, each
    tenant ``singles`` singletons of 1-4 chips and ``gangs`` plain gangs
    of ``gang_size`` x 4 chips."""
    rng = np.random.default_rng(seed)
    flood = [(f"f-{i:04d}", "flood", {"tpu/chips": "1"}) for i in range(size["flood"])]
    teams = []
    for t in TEAMS:
        for i in range(size["singles"]):
            teams.append((f"{t}-s{i:02d}", t, {"tpu/chips": str(int(rng.integers(1, 5)))}))
        for g in range(size["gangs"]):
            teams += [(f"{t}-g{g}-{m}", t, {"tpu/chips": "4", "tpu/gang": f"{t}-g{g}",
                                            "tpu/gang-size": str(size["gang_size"])})
                      for m in range(size["gang_size"])]
    return flood, [teams[i] for i in rng.permutation(len(teams))]


def tenancy_stack(platform: str, size: dict, clock=None, **overrides):
    """The stack the shipped ConfigMap describes, on ``platform`` (and with
    ``overrides``), over the fleet of ``size``."""
    from yoda_tpu_torch.config import SchedulerConfig

    cfg = SchedulerConfig.from_dict(configmap_config())
    return build_fleet(platform, cfg.batch_requests, config=cfg, slices=size["slices"],
                       v5e_hosts=size["v5e_hosts"], clock=clock, **overrides)


def pcts(values: "list[float]") -> dict:
    v = sorted(values)
    if not v:
        return {"n": 0, "p50": None, "p99": None}
    return {"n": len(v), "p50": v[len(v) // 2], "p99": v[min(len(v) - 1, int(0.99 * len(v)))]}


def tenant_latencies(created: dict, bound_at: dict) -> dict:
    """Per tenant: p50 / p99 of bind time less creation time, for the pods
    that bound."""
    out = {}
    for tenant in ("flood", *TEAMS):
        out[tenant] = pcts([bound_at[k] - created[k] for k in bound_at
                            if k.startswith(tenant + "/")])
    return out


class KeptRowUpdates:
    """While entered, every ``TorchFleetKernel.update_rows`` that launches on
    the card is held against its plain version: the host lowering of the
    whole refilled fleet (``stack_static``, what ``put_static`` uploads),
    which the resident state must equal once the rows are applied. The
    module's launch count is zeroed on entry."""

    def __enter__(self):
        from yoda_tpu_torch.ops import kernel as kernel_mod

        self.mod = kernel_mod
        self.real = real = kernel_mod.TorchFleetKernel.update_rows
        self.held = self.rows = self.max_abs_err = 0

        self.threads: set = set()

        def update_rows(kern, arrays, rows):
            before = kern.row_updates
            real(kern, arrays, rows)
            if kern.row_updates != before:
                self.threads.add(threading.current_thread().name)
                chips, nodes = kernel_mod.stack_static(arrays)
                err = max(abs_err(kern._chips, torch.from_numpy(chips)),
                          abs_err(kern._nodes, torch.from_numpy(nodes)))
                self.held += 1
                self.rows += len(rows)
                self.max_abs_err = max(self.max_abs_err, err)

        kernel_mod.TorchFleetKernel.update_rows = update_rows
        kernel_mod.row_update_launches = 0
        return self

    def __exit__(self, *exc):
        self.mod.TorchFleetKernel.update_rows = self.real
        self.launches = self.mod.row_update_launches
        return False


def kept_counts(kept: KeptKernels, rows: KeptRowUpdates) -> dict:
    """Launches made and held against the plain versions, per kernel, with
    the largest difference."""
    err = kept.errors()
    err["launches"]["update_rows"] = rows.launches
    err["kept"]["update_rows"] = rows.held
    err["max_abs_err"]["update_rows"] = rows.max_abs_err
    err["launch_threads"] = sorted(kept.threads | rows.threads)
    return err


def event_rows(stack) -> list:
    """Every Event the stack wrote as [reason, namespace/pod, count]."""
    if not stack.events.flush(60.0):
        raise AssertionError("the Event recorder did not drain")
    return sorted([e["reason"], f"{e['involvedObject']['namespace']}/"
                   f"{e['involvedObject']['name']}", e["count"]]
                  for e in stack.cluster.list_events())


def gang_split(stack, pods: list) -> dict:
    """Gangs bound partly: gang -> (bound members, size)."""
    from yoda_tpu_torch.api.requests import gang_name_of

    bound: dict = {}
    for _name, _ns, labels in pods:
        g = gang_name_of(labels)
        if g:
            bound.setdefault(g, [0, int(labels["tpu/gang-size"])])
    for p in stack.cluster.list_pods():
        g = gang_name_of(p.labels)
        if g in bound and p.node_name:
            bound[g][0] += 1
    return {g: tuple(v) for g, v in bound.items() if v[0] not in (0, v[1])}


def run_tenancy_stepped(platform: str, size: dict, *, fairness: bool = True,
                        quota: int = 0) -> dict:
    """Run (k1) (or, with ``quota``, (k2)) on one kernel_platform: the
    ConfigMap's stack on a stepped scheduling clock (1 s per step). Step 0
    creates the flood, step 1 the light tenants' pods; every later step
    the agent republishes ``republish`` hosts in turn and ``deletes`` bound
    flood pods are deleted. Each step then runs up to ``turns`` loop turns
    (a pop, its batch, one cycle per entry), the batcher flushed before
    each turn, so batch boundaries at every dispatch are the script's on
    both platforms. The run ends when a step pops nothing and nothing
    waits for a retry, or after ``quota_steps`` steps with a quota."""
    from yoda_tpu_torch.api.types import PodSpec

    over = {}
    if not fairness:
        over["tenant_fairness"] = False
    if quota:
        over["tenant_quota_chips"] = quota
    clock = SteppedClock(10_000.0)
    stack, agent = tenancy_stack(platform, size, clock=clock, **over)
    ing, sched, queue, m = stack.ingestor, stack.scheduler, stack.queue, stack.metrics
    flood, teams = tenancy_script(size)
    hosts = sorted(t.name for t in stack.cluster.list_tpu_metrics())
    created, bound_at, pops, steps = {}, {}, [], []
    quota_explain = None
    t0 = time.monotonic()
    try:
        with KeptKernels() as kept, KeptRowUpdates() as rows:
            def create(script):
                for name, ns, labels in script:
                    stack.cluster.create_pod(PodSpec(name, namespace=ns, labels=dict(labels)))
                    created[f"{ns}/{name}"] = clock()

            create(flood)
            step = 0
            while step < (size["quota_steps"] if quota else 1000):
                if step == 1:
                    create(teams)
                if step:
                    at = (step - 1) * size["republish"] % len(hosts)
                    for h in (hosts + hosts)[at:at + size["republish"]]:
                        agent.refresh(h)
                    for key in sorted(k for k in bound_at if k.startswith("flood/")
                                      and stack.cluster.get_pod(k))[:size["deletes"]]:
                        stack.cluster.delete_pod(key)
                turns = 0
                while turns < size["turns"]:
                    ing.flush()
                    qpi = queue.pop(timeout=0)
                    if qpi is None:
                        break
                    for q in sched._pop_batch(qpi):
                        pops.append(q.pod.key)
                        sched.schedule_one(q)
                    turns += 1
                ing.flush()
                for p in stack.cluster.list_pods():
                    if p.node_name and p.key not in bound_at:
                        bound_at[p.key] = clock()
                steps.append(dict(
                    turns=turns, bound=len(bound_at),
                    shares=stack.tenants.shares() if stack.tenants else {},
                    flood_usage=stack.tenants.usage("flood")[0] if stack.tenants else None,
                    quota_parks=m.tenant_quota_parks.value(),
                    pending=m.pending.summary()["by_kind"],
                ))
                if quota and quota_explain is None:
                    parked = sorted(row["key"] for row in m.pending.summary()["pending"]
                                    if row["kind"] == "quota-park")
                    if parked:
                        quota_explain = no_wall(m.pending.explain(parked[0]))
                clock.advance(1.0)
                step += 1
                if not quota and step > 1 and turns == 0 \
                        and not queue.pending_retry_count():
                    break
            if platform != "cpu":
                torch.cuda.synchronize()
        wall = time.monotonic() - t0
        r = stack.batch._resident
        out = dict(
            platform=platform, fairness=fairness, quota=quota, steps=steps,
            pods=len(created), bound=len(bound_at), pops=pops,
            bindings={k: p.node_name for k in created
                      if (p := stack.cluster.get_pod(k)) is not None},
            events=event_rows(stack), events_dropped=stack.events.dropped_total,
            metrics={k: v for k, v in scrape_values(
                m.registry.render_prometheus()).items()
                if not k.startswith(INGEST_TIMED)},
            latency_s=tenant_latencies(created, bound_at),
            rows_applied=r.rows_applied if r else None,
            delta_syncs=r.delta_syncs if r else None,
            restacks=stack.batch.restacks,
            ingest_events_in=ing.events_in,
            ingest=dict(events_out=ing.events_out, batches=ing.batches),
            quota_parked=max(s["pending"].get("quota-park", 0) for s in steps),
            quota_explain=quota_explain,
            overcommitted=over_capacity(stack), accounting_gap=accounting_gap(stack),
            split_gangs=gang_split(stack, flood + teams),
            **dispatch_health(stack.batch), wall_s=wall,
            **kept_counts(kept, rows),
        )
    finally:
        stack.close()
    return out


def run_tenancy_wall(platform: str, size: dict) -> dict:
    """Run (k3) on one kernel_platform: the ConfigMap's stack on the wall
    clock with the batcher's own drain thread at the 2 ms window. A
    publisher thread republishes every host's metrics CR once per
    ``publish_period_s`` (the agent's 10 s interval: 500 CRs/s over 5,000
    hosts), and once, ``rollout_at_s`` in, every host within
    ``rollout_s`` (an agent rollout); it also ticks the overload ladder
    once a second and samples the batcher's backlog after every publish.
    The main thread creates (k1)'s pods and serves them with
    ``run_until_idle``."""
    from yoda_tpu_torch.api.types import PodSpec

    stack, agent = tenancy_stack(platform, size)
    ing, sched, m = stack.ingestor, stack.scheduler, stack.metrics
    ov = m.overload
    flood, teams = tenancy_script(size)
    hosts = sorted(t.name for t in stack.cluster.list_tpu_metrics())
    bound_wall: dict = {}

    def on_event(e) -> None:
        if e.kind == "Pod" and e.type != "deleted" and e.obj.node_name:
            bound_wall.setdefault(e.obj.key, time.monotonic())

    stack.cluster.add_watcher(on_event)
    batches: list = []
    real_on_batch = ing.on_batch

    def on_batch(raw: int, applied: int) -> None:
        batches.append((raw, applied))
        real_on_batch(raw, applied)

    ing.on_batch = on_batch
    stop = threading.Event()
    pub = dict(published=0, backlog_max=0, ladder=[], errors=[], rollout_s=None)

    def publisher() -> None:
        start = time.monotonic()
        gap = size["publish_period_s"] / len(hosts)
        next_eval, i, rolled = start + 1.0, 0, False
        try:
            while not stop.is_set():
                now = time.monotonic()
                if not rolled and now - start >= size["rollout_at_s"]:
                    t_roll = time.monotonic()
                    for j, h in enumerate(hosts):
                        agent.refresh(h)
                        pub["backlog_max"] = max(pub["backlog_max"], ing.backlog())
                        ahead = t_roll + (j + 1) * size["rollout_s"] / len(hosts) \
                            - time.monotonic()
                        if ahead > 0:
                            stop.wait(ahead)
                    pub["published"] += len(hosts)
                    pub["rollout_s"] = time.monotonic() - t_roll
                    rolled = True
                    continue
                agent.refresh(hosts[i % len(hosts)])
                i += 1
                pub["published"] += 1
                pub["backlog_max"] = max(pub["backlog_max"], ing.backlog())
                if now >= next_eval:
                    p = ov.pressure()
                    level = ov.evaluate()
                    pub["ladder"].append(dict(t_s=now - start, level=level,
                                              ingest=p.get("ingest"), max=p["max"]))
                    next_eval += 1.0
                ahead = start + i * gap - time.monotonic()
                if ahead > 0:
                    stop.wait(ahead)
        except Exception as e:  # noqa: BLE001 — reported, and fails the run
            pub["errors"].append(f"{type(e).__name__}: {e}")

    created = {}
    try:
        with KeptKernels() as kept, KeptRowUpdates() as rows:
            thread = threading.Thread(target=publisher, name="k3-publisher", daemon=True)
            t0 = time.monotonic()
            thread.start()
            for name, ns, labels in flood + teams:
                stack.cluster.create_pod(PodSpec(name, namespace=ns, labels=dict(labels)))
                created[f"{ns}/{name}"] = time.monotonic()
            ing.flush()
            sched.run_until_idle(max_wall_s=600.0)
            wall = time.monotonic() - t0
            while time.monotonic() - t0 < size["rollout_at_s"] + size["rollout_s"] + 1.0:
                time.sleep(0.05)  # the rollout lands in every run
            stop.set()
            thread.join(timeout=30)
            ing.flush()
            if platform != "cpu":
                torch.cuda.synchronize()
        r = stack.batch._resident
        events = event_rows(stack)
        scheduled = {}
        for reason, key, count in events:
            if reason == "Scheduled":
                scheduled[key] = scheduled.get(key, 0) + count
        bound = sorted(k for k in created if (p := stack.cluster.get_pod(k)) and p.node_name)
        pending_keys = {row["key"] for row in m.pending.summary()["pending"]}
        sizes = sorted(a for _, a in batches if a)
        out = dict(
            platform=platform, pods=len(created), bound=bound,
            unbound_without_reason=sorted(set(created) - set(bound) - pending_keys),
            pods_per_s=len(bound) / wall, wall_s=wall,
            latency_ms={t: {k: (None if v is None else 1e3 * v) if k != "n" else v
                            for k, v in d.items()}
                        for t, d in tenant_latencies(created, bound_wall).items()},
            batches=len(batches), batch_p50=sizes[len(sizes) // 2] if sizes else None,
            batch_max=sizes[-1] if sizes else None,
            events_in=ing.events_in, events_out=ing.events_out,
            backlog_max=pub["backlog_max"], published=pub["published"],
            rollout_s=pub["rollout_s"], ladder=pub["ladder"],
            publisher_errors=pub["errors"], publisher_alive=thread.is_alive(),
            update_rows_calls=r.delta_syncs if r else None,
            rows_per_update=(r.rows_applied / r.delta_syncs) if r and r.delta_syncs else None,
            events_written=len(events), events_dropped=stack.events.dropped_total,
            scheduled_events_not_one=sorted(k for k in bound if scheduled.get(k) != 1),
            overcommitted=over_capacity(stack), accounting_gap=accounting_gap(stack),
            split_gangs=gang_split(stack, flood + teams),
            **dispatch_health(stack.batch),
            **kept_counts(kept, rows),
        )
    finally:
        stop.set()
        stack.close()
    return out


def run_tenancy(platform: str, size: dict = TENANCY_FULL, *, reported: bool = True) -> dict:
    """Run (k) on one kernel_platform: (k1), (k2) and (k3), compared across
    platforms, and with ``reported`` (k1) again with tenant fairness off,
    whose latencies are printed beside the fair run's."""
    parts = {"k1": lambda: run_tenancy_stepped(platform, size),
             "k2": lambda: run_tenancy_stepped(platform, size, quota=size["quota"]),
             "k3": lambda: run_tenancy_wall(platform, size)}
    if reported:
        parts["k1_unfair"] = lambda: run_tenancy_stepped(platform, size, fairness=False)
    out: dict = {}
    for part, fn in parts.items():
        t = time.monotonic()
        out[part] = fn()
        out[part]["part_s"] = time.monotonic() - t
    return out


TENANCY_PARITY = {
    "k1": ("bindings", "pops", "events", "metrics", "steps", "rows_applied",
           "delta_syncs", "restacks", "ingest_events_in", "latency_s"),
    "k2": ("bindings", "pops", "events", "metrics", "steps", "rows_applied",
           "delta_syncs", "quota_parked", "quota_explain", "latency_s"),
}


def check_tenancy_run(run: dict, size: dict) -> None:
    """The checks each platform's run (k) must pass on its own."""
    name = f"run k ({run['k1']['platform']})"
    for part in [p for p in ("k1", "k2", "k3", "k1_unfair") if p in run]:
        r = run[part]
        if r["overcommitted"] or r["accounting_gap"] or demoted(r) or r["split_gangs"]:
            raise AssertionError(f"{name} {part}: over capacity {r['overcommitted']}, "
                                 f"accounting {r['accounting_gap']}, dispatch chain "
                                 f"{demoted(r)}, split gangs {r['split_gangs']}")
        if r["kept"] != r["launches"] or any(r["max_abs_err"].values()):
            raise AssertionError(f"{name} {part}: {r['kept']} launches held against the "
                                 f"plain versions of {r['launches']}, differences "
                                 f"{r['max_abs_err']}")
    for part in [p for p in ("k1", "k1_unfair") if p in run]:
        r = run[part]
        if r["bound"] != r["pods"]:
            raise AssertionError(f"{name} {part}: {r['bound']}/{r['pods']} bound")
        scheduled = sum(c for reason, _k, c in r["events"] if reason == "Scheduled")
        if scheduled != r["pods"] or r["events_dropped"]:
            raise AssertionError(f"{name} {part}: {scheduled} Scheduled events for "
                                 f"{r['pods']} binds, {r['events_dropped']} dropped")
    k1 = run["k1"]
    if set(k1["steps"][-1]["shares"]) != {"flood", *TEAMS}:
        raise AssertionError(f"{name} k1: dominant shares {k1['steps'][-1]['shares']}")
    # DRF orders by dominant share, not arrival: a light tenant whose gangs
    # bound can sit above the flood's share for a while, so its tail may
    # wait; its median may not.
    light = [k1["latency_s"][t]["p50"] for t in TEAMS]
    if max(light) >= k1["latency_s"]["flood"]["p50"]:
        raise AssertionError(f"{name} k1: light tenants' p50 {light} not under the "
                             f"flood's {k1['latency_s']['flood']}")
    if not sum(run[p]["launches"]["update_rows"] for p in ("k1", "k2", "k3")) and \
            run["k1"]["platform"] != "cpu":
        raise AssertionError(f"{name}: no update_rows launch in run (k)")
    if "k1_unfair" in run:
        unfair = [run["k1_unfair"]["latency_s"][t]["p50"] for t in TEAMS]
        fair = [k1["latency_s"][t]["p50"] for t in TEAMS]
        if not all(f < u for f, u in zip(fair, unfair)):
            raise AssertionError(f"{name}: fairness off did not delay the light "
                                 f"tenants (p50 fair {fair}, unfair {unfair})")
    k2 = run["k2"]
    usage = [s["flood_usage"] for s in k2["steps"]]
    first_park = next((i for i, s in enumerate(k2["steps"]) if s["quota_parks"]), None)
    if first_park is None or not k2["quota_parked"] \
            or max(usage) > size["quota"] \
            or "over chip quota" not in (k2["quota_explain"] or {}).get("last_message", ""):
        raise AssertionError(f"{name} k2: parks {[s['quota_parks'] for s in k2['steps']]}, "
                             f"flood chips {usage}, explain {k2['quota_explain']}")
    bound = [s["bound"] for s in k2["steps"]]
    if not bound[-1] > bound[first_park]:
        raise AssertionError(f"{name} k2: no parked pod bound after the deletions {bound}")
    for team in TEAMS:
        if k2["latency_s"][team]["n"] != size["singles"] + size["gangs"] * size["gang_size"]:
            raise AssertionError(f"{name} k2: tenant {team} {k2['latency_s'][team]}")
    k3 = run["k3"]
    if k3["unbound_without_reason"] or k3["scheduled_events_not_one"] \
            or k3["publisher_errors"] or k3["publisher_alive"] \
            or not k3["rollout_s"] or not k3["ladder"]:
        raise AssertionError(f"{name} k3: unbound without a verdict "
                             f"{k3['unbound_without_reason'][:5]}, Scheduled events not "
                             f"one {k3['scheduled_events_not_one'][:5]}, publisher "
                             f"{k3['publisher_errors']} alive {k3['publisher_alive']}, "
                             f"rollout {k3['rollout_s']}, ladder {k3['ladder'][:2]}")


def check_tenancy(g: dict, c: dict, size: dict) -> None:
    """Run (k) on the card against the same script on the CPU."""
    diff = [f"{part}.{k}" for part, keys in TENANCY_PARITY.items() for k in keys
            if g[part][k] != c[part][k]]
    if diff:
        raise AssertionError(f"run k: cuda != cpu in {diff}")
    check_tenancy_run(g, size)
    check_tenancy_run(c, size)
    for part in ("k1", "k2", "k3"):
        if any(c[part]["launches"].values()):
            raise AssertionError(f"run k {part}: the CPU run launched on the card")
        if not g[part]["launches"]["fleet_eval"]:
            raise AssertionError(f"run k {part}: launches {g[part]['launches']}")
    if not g["k3"]["launches"]["update_rows"]:
        raise AssertionError("run k3: the rollout moved no resident row")
    if not g["k1"]["launches"]["joint_fit"]:
        raise AssertionError("run k1: no joint_fit launch on the card")


def print_tenancy(run: dict, smi: str) -> None:
    """Run (k)'s measurements, less its bindings, pops, events and samples."""
    summary = {}
    for part, r in run.items():
        summary[part] = {k: v for k, v in r.items()
                         if k not in ("bindings", "pops", "events", "metrics", "steps",
                                      "bound", "ladder")}
        if "steps" in r:
            summary[part]["steps"] = len(r["steps"])
            summary[part]["final_shares"] = r["steps"][-1]["shares"]
            summary[part]["quota_parks_by_step"] = [s["quota_parks"] for s in r["steps"]]
        if part == "k3":
            summary[part]["bound"] = len(r["bound"])
            summary[part]["ladder"] = r["ladder"][:12]
    print(f"tenancy (k) {run['k1']['platform']} [{smi}]:", json.dumps(summary))


def phase_tenancy(smi: str, rerun: SpawnedRerun) -> dict:
    g = run_tenancy("auto")
    c = rerun.result()
    print_tenancy(g, smi)
    print_tenancy(c, smi)
    check_tenancy(g, c, TENANCY_FULL)
    return g


# --- run (l): the scheduler process -----------------------------------------

# (l1) / (l2) over the wire. The fleet is the 5,000-node one; the traffic's
# depth is cut (run (c)'s gang mix at a quarter of its gangs, half of run
# (b)'s singletons) so the phase stays under a minute of card
# time.
PROCESS_FULL = dict(slices=512, v5e_hosts=2952, singles=128, plain=4, plain_size=16,
                    cosched=4, topo=8, failover=128)
PROCESS_SMALL = dict(slices=8, v5e_hosts=40, singles=16, plain=2, plain_size=4,
                     cosched=2, topo=2, failover=16)
# (l3): the stepped pipeline, the same fleet over FakeCluster(bind_latency_s).
PIPELINE_FULL = dict(slices=512, v5e_hosts=2952, plain=4, plain_size=16, topo=8,
                     singles=64, latency_s=0.002)
PIPELINE_SMALL = dict(slices=8, v5e_hosts=40, plain=2, plain_size=4, topo=2,
                      singles=8, latency_s=0.002)
PIPELINE_PARITY = ("bindings", "gang_hosts", "rollbacks", "events", "failed_binds")
LEASE = "kube-system/yoda-tpu-scheduler"


def process_fleet(size: dict) -> "tuple[list[tuple[str, dict, dict]], dict, dict]":
    """The fleet of ``size`` as API objects: (host, TpuNodeMetrics CR, Node)
    per host, published by the port's FakeTpuAgent into a scratch
    FakeCluster; and each host's healthy chips and slice."""
    from yoda_tpu_torch.agent.fake_publisher import FakeTpuAgent
    from yoda_tpu_torch.api.types import K8sNode
    from yoda_tpu_torch.cluster.fake import FakeCluster

    scratch = FakeCluster()
    agent = FakeTpuAgent(scratch)
    for s in range(size["slices"]):
        agent.add_slice(f"v5p-{s:03d}", generation="v5p", host_topology=(2, 2, 1))
    for h in range(size["v5e_hosts"]):
        agent.add_host(f"v5e-{h:04d}", generation="v5e", chips=8)
    agent.publish_all()
    out, capacity, slice_of = [], {}, {}
    for t in scratch.list_tpu_metrics():
        node = K8sNode(t.name, labels={HOST_KEY: t.name, "pool": t.generation})
        out.append((t.name, t.to_obj(), node.to_obj()))
        capacity[t.name] = sum(c.healthy for c in t.chips)
        slice_of[t.name] = t.slice_id
    return out, capacity, slice_of


def process_pods(size: dict, seed: int = 21):
    """(l1)'s pods as (name, labels) in a seeded order: run (b)'s singleton
    mix, then plain gangs of v5e x 8 chips, coscheduling-alias gangs of 4 x
    4 chips and topology gangs (2x2x1, 4 v5p x 4 chips) as run (c) makes
    them; and the gangs, name -> (kind, size)."""
    rng = np.random.default_rng(seed)
    singles = fleet_and_pods(seed)[1][: size["singles"]]
    pods = [(f"s-{n}", labels) for n, labels in singles]
    gangs: dict[str, tuple[str, int]] = {}
    for g in range(size["plain"]):
        name = f"plain{g}"
        gangs[name] = ("plain", size["plain_size"])
        pods += [(f"{name}-{i:02d}", {"tpu/gang": name, "tpu/gang-size": str(size["plain_size"]),
                                      "tpu/chips": "8", "tpu/generation": "v5e"})
                 for i in range(size["plain_size"])]
    for g in range(size["cosched"]):
        name = f"cosched{g}"
        gangs[name] = ("cosched", 4)
        pods += [(f"{name}-{i:02d}", {"pod-group.scheduling.sigs.k8s.io/name": name,
                                      "pod-group.scheduling.sigs.k8s.io/min-available": "4",
                                      "tpu/chips": "4"}) for i in range(4)]
    for g in range(size["topo"]):
        name = f"topo{g}"
        gangs[name] = ("topology", 4)
        pods += [(f"{name}-{i:02d}", {"tpu/gang": name, "tpu/topology": "2x2x1",
                                      "tpu/chips": "4", "tpu/generation": "v5p"})
                 for i in range(4)]
    return [pods[i] for i in rng.permutation(len(pods))], gangs


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def http_get(url: str, timeout: float = 5.0) -> "tuple[int, str]":
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(url, timeout=timeout) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, ""
    except OSError:
        return 0, ""


def wait_for(cond, timeout_s: float, what: str, poll_s: float = 0.02) -> float:
    """Poll ``cond`` until true; the monotonic instant it held. Raises after
    ``timeout_s``."""
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if cond():
            return time.monotonic()
        time.sleep(poll_s)
    raise AssertionError(f"timed out after {timeout_s} s waiting for {what}")


class Replicas:
    """CLI replicas (``yoda_tpu_torch.cli.main``), each on a thread of its
    own with its own stop event, against one API server. While entered,
    ``standalone.build_stack`` — which the CLI reaches through the module
    attribute — records each replica's stack (by its thread's name) and
    instruments it: the warm-start resync's end and the first pop's start
    on the monotonic clock, and the bind executor's largest in-flight
    count. ``cli._build_kube_cluster`` and ``cli._init_device`` are timed
    the same way."""

    def __init__(self, base_url: str) -> None:
        self.base_url = base_url
        self.stacks: dict = {}
        self.timing: dict = {}
        self.threads: dict = {}
        self.stops: dict = {}
        self.rc: dict = {}

    def __enter__(self):
        import os

        from yoda_tpu_torch import cli, standalone

        self.cli, self.standalone = cli, standalone
        self.real = (standalone.build_stack, cli._build_kube_cluster, cli._init_device)
        real_build, real_sync, real_init = self.real
        self.env = os.environ.get("YODA_KUBE_API_URL")
        os.environ["YODA_KUBE_API_URL"] = self.base_url

        def timing() -> dict:
            return self.timing.setdefault(threading.current_thread().name, {})

        def build_stack(*args, **kw):
            stack = real_build(*args, **kw)
            me = threading.current_thread().name
            t = timing()
            resync = stack.reconciler.resync

            def timed_resync():
                t["resync_start"] = time.monotonic()
                out = resync()
                t["resync_end"] = time.monotonic()
                t["resyncs"] = t.get("resyncs", 0) + 1
                return out

            stack.reconciler.resync = timed_resync
            schedule_one = stack.scheduler.schedule_one

            def first_pop(qpi):
                t.setdefault("first_pop", time.monotonic())
                return schedule_one(qpi)

            stack.scheduler.schedule_one = first_pop
            ex = stack.bind_executor
            if ex is not None:
                submit = ex.submit

                def counted(fn):
                    fut = submit(fn)
                    t["max_inflight"] = max(t.get("max_inflight", 0), ex.inflight())
                    return fut

                ex.submit = counted
            self.stacks[me] = stack
            return stack

        def build_kube_cluster(*args, **kw):
            t0 = time.monotonic()
            out = real_sync(*args, **kw)
            timing()["sync_ms"] = 1e3 * (time.monotonic() - t0)
            return out

        def init_device(platform):
            t0 = time.monotonic()
            out = real_init(platform)
            timing()["device_init_s"] = time.monotonic() - t0
            return out

        standalone.build_stack = build_stack
        cli._build_kube_cluster, cli._init_device = build_kube_cluster, init_device
        return self

    def start(self, name: str, argv: "list[str]") -> None:
        stop = threading.Event()

        def run():
            try:
                self.rc[name] = self.cli.main(argv, stop=stop)
            except BaseException as e:  # noqa: BLE001 — the phase reports it
                self.rc[name] = f"{type(e).__name__}: {e}"

        t = threading.Thread(target=run, name=name, daemon=True)
        self.threads[name], self.stops[name] = t, stop
        t.start()

    def stop(self, name: str, timeout_s: float = 60.0) -> None:
        self.stops[name].set()
        self.threads[name].join(timeout=timeout_s)
        if self.threads[name].is_alive():
            raise AssertionError(f"replica {name} did not stop in {timeout_s} s")

    def __exit__(self, *exc):
        import os

        for name in self.threads:
            self.stops[name].set()
        for t in self.threads.values():
            t.join(timeout=60)
        self.standalone.build_stack = self.real[0]
        self.cli._build_kube_cluster, self.cli._init_device = self.real[1:]
        if self.env is None:
            os.environ.pop("YODA_KUBE_API_URL", None)
        else:
            os.environ["YODA_KUBE_API_URL"] = self.env
        return False


def publish(server, fleet) -> None:
    for name, cr, node in fleet:
        server.put_object("TpuNodeMetrics", name, cr)
        server.put_object("Node", name, node)


class Republisher:
    """The node agents' heartbeat while entered: a thread republishes
    every host's CR with a fresh ``lastUpdatedUnix`` once per
    ``period_s`` (the agent's default interval), spread evenly over the
    period, into the API server — without it the health monitor's ladder
    fences every host 15 s in."""

    def __init__(self, server, fleet, period_s: float = 10.0, tick_s: float = 0.1) -> None:
        self.server, self.fleet = server, fleet
        self.period_s, self.tick_s = period_s, tick_s
        self.stop = threading.Event()
        self.published = 0

    def run(self) -> None:
        per_tick = max(1, int(len(self.fleet) * self.tick_s / self.period_s))
        i = 0
        while not self.stop.wait(self.tick_s):
            for _ in range(per_tick):
                name, cr, _node = self.fleet[i % len(self.fleet)]
                cr["status"]["lastUpdatedUnix"] = time.time()
                self.server.put_object("TpuNodeMetrics", name, cr)
                i += 1
            self.published = i

    def __enter__(self):
        self.thread = threading.Thread(target=self.run, name="republisher", daemon=True)
        self.thread.start()
        return self

    def __exit__(self, *exc):
        self.stop.set()
        self.thread.join(timeout=10)
        return False


def api_server_child(conn, size: dict, period_s: float) -> None:
    """The body of the API server's process: the port's FakeKubeApiServer
    holding the fleet of ``size``, its agents' heartbeat
    (:class:`Republisher`), and the parent's queries over ``conn`` until
    "stop"."""
    from yoda_tpu_torch.testing import FakeKubeApiServer

    fleet, capacity, slice_of = process_fleet(size)
    server = FakeKubeApiServer().start()
    publish(server, fleet)
    ops = {"get_object": server.get_object, "bindings": server.bindings,
           "bound": lambda keys: bound_nodes(server, keys), "put_object": server.put_object}
    conn.send((server.base_url, len(fleet), capacity, slice_of))
    with Republisher(server, fleet, period_s=period_s) as agents:
        while True:
            op, args = conn.recv()
            if op == "stop":
                break
            try:
                conn.send(("ok", ops[op](*args)))
            except Exception as e:  # noqa: BLE001 — the parent raises it
                conn.send(("error", f"{type(e).__name__}: {e}"))
        published = agents.published
    server.stop()
    conn.send(("ok", published))
    conn.close()


class ApiServerProcess:
    """The API server in a process of its own (spawned), as a cluster's
    API server is: its HTTP threads, watch streams and the agents' 500
    CR republishes a second at 5,000 hosts do not take the scheduler's
    interpreter lock. The parent reads it through the same methods as a
    ``FakeKubeApiServer`` (``get_object``, ``bindings``) plus ``bound``;
    ``republished`` counts the heartbeats once it has stopped."""

    def __init__(self, size: dict, period_s: float = 10.0) -> None:
        import multiprocessing

        ctx = multiprocessing.get_context("spawn")
        self._conn, child = ctx.Pipe()
        self._proc = ctx.Process(target=api_server_child, args=(child, size, period_s),
                                 daemon=True)
        self.size, self.republished = size, None

    def __enter__(self):
        self._proc.start()
        if not self._conn.poll(300):
            raise TimeoutError("the API server process sent nothing in 300 s")
        self.base_url, self.nodes, self.capacity, self.slice_of = self._conn.recv()
        return self

    def _call(self, op: str, *args):
        self._conn.send((op, args))
        if not self._conn.poll(120):
            raise TimeoutError(f"the API server process did not answer {op}")
        status, value = self._conn.recv()
        if status != "ok":
            raise RuntimeError(f"API server process: {value}")
        return value

    def get_object(self, kind: str, key: str):
        return self._call("get_object", kind, key)

    def bindings(self) -> list:
        return self._call("bindings")

    def put_object(self, kind: str, key: str, obj: dict) -> None:
        self._call("put_object", kind, key, obj)

    def bound(self, keys) -> dict:
        return self._call("bound", list(keys))

    def __exit__(self, *exc):
        try:
            self._conn.send(("stop", ()))
            if self._conn.poll(60):
                self.republished = self._conn.recv()[1]
        finally:
            self._proc.join(timeout=30)
            if self._proc.is_alive():
                self._proc.terminate()
                self._proc.join(timeout=10)
        return False


def seed_client(server):
    from yoda_tpu_torch.cluster import KubeApiClient, KubeApiConfig, KubeCluster

    return KubeCluster(KubeApiClient(KubeApiConfig(base_url=server.base_url)),
                       kinds=("Pod",))


def create_pods(client, pods) -> dict:
    """POST each (name, labels) pod; its creation instant (monotonic, just
    before the POST) by pod key."""
    from yoda_tpu_torch.api.types import PodSpec

    created = {}
    for name, labels in pods:
        created[f"default/{name}"] = time.monotonic()
        client.create_pod(PodSpec(name, labels=dict(labels)))
    return created


def bound_nodes(server, keys) -> dict:
    out = {}
    for key in keys:
        obj = server.get_object("Pod", key) or {}
        out[key] = (obj.get("spec") or {}).get("nodeName")
    return out


def binding_counts(log) -> "tuple[dict, dict, int]":
    """From the API server's binding log: per pod, binding POSTs and the
    first accepted POST's monotonic instant; and the 409 answers."""
    posts, at, conflicts = {}, {}, 0
    for key, _node, status, mono, _wall in log:
        posts[key] = posts.get(key, 0) + 1
        if status == 201:
            at.setdefault(key, mono)
        elif status == 409:
            conflicts += 1
    return posts, at, conflicts


def pending_why(stack, keys, labels_of: dict) -> dict:
    """Each key's why-pending verdict kind (its own record, else its
    gang's), None where nothing is recorded."""
    from yoda_tpu_torch.api.requests import gang_name_of

    out = {}
    for key in keys:
        e = stack.metrics.pending.explain(key)
        g = gang_name_of(labels_of[key])
        if e is None and g is not None:
            e = stack.metrics.pending.explain(g)
        out[key] = None if e is None else e["kind"]
    return out


def wire_checks(bound: dict, labels_of: dict, gangs: dict, capacity: dict,
                slice_of: dict, posts: dict, why: "dict | None" = None) -> dict:
    """The placement invariants of a run over the wire: every pod bound or
    pending for a recorded reason (``why``), no host over its healthy
    chips, gangs whole (topology gangs on four hosts of one slice), one
    binding POST per pod."""
    from yoda_tpu_torch.api.requests import gang_name_of

    used: dict = {}
    for key, node in bound.items():
        if node is not None:
            used[node] = used.get(node, 0) + int(labels_of[key].get("tpu/chips", "1"))
    members: dict = {}
    for key, labels in labels_of.items():
        g = gang_name_of(labels)
        if g is not None:
            members.setdefault(g, []).append(bound[key])
    split, misplaced = [], []
    for g, nodes in members.items():
        placed = [n for n in nodes if n is not None]
        if len(placed) not in (0, len(nodes)):
            split.append(g)
        if placed and gangs[g][0] == "topology" and (
                len(set(placed)) != 4 or len({slice_of[n] for n in placed}) != 1):
            misplaced.append(g)
    return dict(
        unbound=sorted(k for k, v in bound.items()
                       if v is None and not (why or {}).get(k)),
        over=sorted(h for h, n in used.items() if n > capacity[h]),
        split=sorted(split), misplaced=sorted(misplaced),
        double_posts=sorted(k for k, n in posts.items() if n > 1),
        unposted=sorted(k for k, v in bound.items() if v is not None and k not in posts),
    )


def scrape(port: int) -> dict:
    status, text = http_get(f"http://127.0.0.1:{port}/metrics")
    if status != 200:
        raise AssertionError(f"/metrics answered {status}")
    return scrape_values(text)


def run_wire(platform: str, size: dict = PROCESS_FULL) -> dict:
    """(l1): one CLI replica with --leader-elect against the port's fake
    API server (in its own process) holding the fleet of ``size``: the
    plain gangs created before the replica starts (so the
    lease-to-first-bind time is the process's own, and its first pop is a
    joint pass), the rest over HTTP once /readyz answers 200."""
    from yoda_tpu_torch.api.requests import gang_name_of
    from yoda_tpu_torch.cluster.lease import _parse_micro

    pods, gangs = process_pods(size)
    # The plain gangs wait in the queue before the replica starts, so its
    # first pop gathers them (and nothing else) into one joint pass: the
    # joint-fit gate on the card.
    pre = [p for p in pods if p[0].startswith("plain")]
    pods = [p for p in pods if not p[0].startswith("plain")]
    labels_of = {f"default/{n}": lab for n, lab in pre + pods}
    port = free_port()
    argv = ["--leader-elect", "--lease-identity", "replica-l1",
            "--metrics-port", str(port)] + (["--device", "cpu"] if platform == "cpu" else [])
    with ApiServerProcess(size) as server:
        client = seed_client(server)
        created = create_pods(client, pre)
        with KeptKernels() as kept, KeptRowUpdates() as rows, \
                Replicas(server.base_url) as reps:
            t_start = time.monotonic()
            reps.start("l1", argv)
            t_ready = wait_for(lambda: http_get(f"http://127.0.0.1:{port}/readyz")[0] == 200,
                               300, "/readyz 200")
            stack = reps.stacks["l1"]
            created.update(create_pods(client, pods))
            try:
                wait_for(lambda: all(v is not None for v in server.bound(labels_of).values()),
                         180, "every pod bound", poll_s=0.05)
            except AssertionError:
                pass  # the pods left pending are explained below
            wait_for(lambda: stack.bind_executor.inflight() == 0, 60, "binds settled")
            bound = server.bound(labels_of)
            why = pending_why(stack, [k for k, v in bound.items() if v is None], labels_of)
            values = scrape(port)
            bind_wall = (stack.metrics.bind_wall.quantile(0.5),
                         stack.metrics.bind_wall.quantile(0.99))
            first_cycle_ms = 1e3 * stack.scheduler.stats.results[0].latency_s
            pipeline = dict(parallel_release=stack.gang.parallel_release,
                            workers=stack.bind_executor.workers)
            b = stack.batch
            joint = dict(joint_dispatches=b.joint_dispatches, joint_gangs=b.joint_gangs,
                         fused_plan_dispatches=b.fused_plan_dispatches)
            lease = server.get_object("Lease", LEASE) or {}
            reps.stop("l1")
            rc = reps.rc.get("l1")
            timing = reps.timing["l1"]
        log = server.bindings()
    posts, bound_at, conflicts = binding_counts(log)
    checks = wire_checks(bound, labels_of, gangs, server.capacity, server.slice_of, posts, why)
    main_keys = [f"default/{n}" for n, _ in pods]
    lat = sorted(bound_at[k] - created[k] for k in main_keys if k in bound_at)
    spans: dict = {}
    for k in main_keys:
        g = gang_name_of(labels_of[k])
        if g is not None and k in bound_at:
            lo, hi = spans.get(g, (float("inf"), 0.0))
            spans[g] = (min(lo, created[k]), max(hi, bound_at[k]))
    completion = sorted(hi - lo for lo, hi in spans.values())
    t_acq = _parse_micro((lease.get("spec") or {}).get("acquireTime"))
    first_bind_wall = min(w for _k, _n, s, _m, w in log if s == 201)
    done = [bound_at[k] for k in main_keys if k in bound_at]
    t_first = min(created[k] for k in main_keys)
    return dict(
        platform=platform, nodes=server.nodes, pods=len(labels_of), gangs=len(gangs),
        rc=rc, checks=checks, pipeline=pipeline, conflicts=conflicts,
        republished=server.republished,
        bound=sum(v is not None for v in bound.values()),
        pending_why={k: sum(1 for v in why.values() if v == k) for k in set(why.values())},
        overload_level=values.get("yoda_overload_level"),
        holder=(lease.get("spec") or {}).get("holderIdentity"),
        device_init_s=timing.get("device_init_s"), informer_sync_ms=timing.get("sync_ms"),
        start_to_ready_s=t_ready - t_start,
        lease_to_first_bind_ms=None if t_acq is None else 1e3 * (first_bind_wall - t_acq),
        first_cycle_ms=first_cycle_ms,
        pods_per_s=len(done) / (max(done) - t_first) if done else 0.0,
        p50_ms=pct_ms(lat, 0.5), p99_ms=pct_ms(lat, 0.99),
        gang_p50_ms=pct_ms(completion, 0.5), gang_p99_ms=pct_ms(completion, 0.99),
        bind_wall_p50_ms=bind_wall[0], bind_wall_p99_ms=bind_wall[1],
        max_bind_inflight=timing.get("max_inflight", 0),
        overlap_cycles=values.get("yoda_overlap_cycles_total", 0.0),
        resyncs=timing.get("resyncs", 0),
        resync_before_first_pop=timing.get("resync_end", float("inf"))
        <= timing.get("first_pop", float("-inf")),
        **joint,
        **kept_counts(kept, rows),
    )


def run_failover(platform: str, size: dict = PROCESS_FULL) -> dict:
    """(l2): two replicas in one process, each with its own stop and lease
    identity. The leader binds the first half of ``failover`` singletons;
    then it is stopped and the second half created: the standby takes the
    lease, runs its resync before its first pop and binds the rest."""
    singles = fleet_and_pods(22)[1][: size["failover"]]
    half = len(singles) // 2
    first = [(f"a-{n}", lab) for n, lab in singles[:half]]
    second = [(f"b-{n}", lab) for n, lab in singles[half:]]
    labels_of = {f"default/{n}": lab for n, lab in first + second}
    ports = {"a": free_port(), "b": free_port()}
    dev = ["--device", "cpu"] if platform == "cpu" else []

    def holder():
        return ((server.get_object("Lease", LEASE) or {}).get("spec") or {}).get(
            "holderIdentity")

    with ApiServerProcess(size) as server:
        client = seed_client(server)
        with KeptKernels() as kept, KeptRowUpdates() as rows, \
                Replicas(server.base_url) as reps:
            for r in ("a", "b"):
                reps.start(r, ["--leader-elect", "--lease-identity", f"replica-{r}",
                               "--metrics-port", str(ports[r])] + dev)
                if r == "a":
                    wait_for(lambda: http_get(f"http://127.0.0.1:{ports['a']}/readyz")[0]
                             == 200, 300, "replica a ready")
            wait_for(lambda: http_get(f"http://127.0.0.1:{ports['b']}/healthz")[0] == 200,
                     300, "replica b up (standby)")
            standby_ready = http_get(f"http://127.0.0.1:{ports['b']}/readyz")[0]
            holder_before = holder()
            create_pods(client, first)
            wait_for(lambda: all(v is not None for v in
                                 server.bound([f"default/{n}" for n, _ in first]).values()),
                     180, "the leader bound the first half", poll_s=0.05)
            t_stop = time.monotonic()
            reps.stops["a"].set()
            created = create_pods(client, second)
            reps.stop("a")
            wait_for(lambda: all(v is not None for v in server.bound(labels_of).values()),
                     180, "the standby bound the rest", poll_s=0.05)
            wait_for(lambda: reps.stacks["b"].bind_executor.inflight() == 0, 60, "settled")
            # A bind lands on the server just before its cycle counts it.
            wait_for(lambda: sum(reps.stacks[r].scheduler.stats.binds for r in ("a", "b"))
                     >= len(labels_of), 10, "every bind counted")
            binds = {r: reps.stacks[r].scheduler.stats.binds for r in ("a", "b")}
            holder_after = holder()
            reps.stop("b")
            rc = dict(reps.rc)
            timing = dict(reps.timing)
        bound = server.bound(labels_of)
        log = server.bindings()
    posts, bound_at, conflicts = binding_counts(log)
    checks = wire_checks(bound, labels_of, {}, server.capacity, server.slice_of, posts)
    second_keys = [f"default/{n}" for n, _ in second]
    tb = timing.get("b", {})
    return dict(
        platform=platform, pods=len(labels_of), rc=rc, checks=checks, conflicts=conflicts,
        holder_before=holder_before, holder_after=holder_after,
        standby_readyz=standby_ready, binds=binds,
        standby_resyncs=tb.get("resyncs", 0),
        standby_resync_before_first_pop=tb.get("resync_end", float("inf"))
        <= tb.get("first_pop", float("-inf")),
        leader_resync_before_first_pop=timing.get("a", {}).get("resync_end", float("inf"))
        <= timing.get("a", {}).get("first_pop", float("-inf")),
        stop_to_standby_first_bind_ms=1e3 * (min(bound_at[k] for k in second_keys) - t_stop),
        stop_to_standby_resync_ms=1e3 * (tb.get("resync_end", t_stop) - t_stop),
        second_half_p50_ms=pct_ms(sorted(bound_at[k] - created[k] for k in second_keys), 0.5),
        **kept_counts(kept, rows),
    )


def pipeline_script(size: dict, seed: int = 23):
    """(l3)'s waves of (name, labels): wave 0 plain and topology gangs with
    singletons in a seeded order, wave 1 one plain gang alone (its first
    member's bind fails once), wave 2 singletons; and the failing pod."""
    rng = np.random.default_rng(seed)
    singles = fleet_and_pods(seed)[1]

    def plain(name):
        return [(f"{name}-{i:02d}", {"tpu/gang": name, "tpu/gang-size": str(size["plain_size"]),
                                     "tpu/chips": "8", "tpu/generation": "v5e"})
                for i in range(size["plain_size"])]

    wave0 = [(f"w0-s{i}", lab) for i, (_n, lab) in enumerate(singles[: size["singles"]])]
    for g in range(size["plain"]):
        wave0 += plain(f"w0-plain{g}")
    for g in range(size["topo"]):
        wave0 += [(f"w0-topo{g}-{i:02d}", {"tpu/gang": f"w0-topo{g}", "tpu/topology": "2x2x1",
                                           "tpu/chips": "4", "tpu/generation": "v5p"})
                  for i in range(4)]
    wave1 = plain("w1-fail")
    wave2 = [(f"w2-s{i}", lab)
             for i, (_n, lab) in enumerate(singles[size["singles"]: 2 * size["singles"]])]
    waves = [[w[i] for i in rng.permutation(len(w))] for w in (wave0, wave1, wave2)]
    return waves, "default/w1-fail-00"


def failing_cluster_class(base):
    """A FakeCluster subclass whose bind of one pod (``fail_key``) fails
    once, non-retryably — after every other member of its gang has bound,
    so the whole rest of the release has landed when it fails and the
    rollback unbinds all of them, whatever the workers' timing. Unbinds
    are logged."""

    class FailingCluster(base):
        def __init__(self, *, fail_key: str, siblings: "list[str]", **kw) -> None:
            super().__init__(**kw)
            self.fail_key, self.siblings = fail_key, siblings
            self.failed = 0
            self.unbinds: list = []

        def bind_pod(self, pod_key, node_name):
            if pod_key == self.fail_key and not self.failed:
                deadline = time.monotonic() + 60
                while time.monotonic() < deadline and not all(
                        (p := self.get_pod(k)) is not None and p.node_name
                        for k in self.siblings):
                    time.sleep(0.001)
                self.failed += 1
                raise ValueError(f"injected bind failure of {pod_key}")
            super().bind_pod(pod_key, node_name)

        def unbind_pod(self, pod_key, node_name):
            self.unbinds.append((pod_key, node_name))
            super().unbind_pod(pod_key, node_name)

    return FailingCluster


def port_modules() -> dict:
    from yoda_tpu_torch import standalone
    from yoda_tpu_torch.agent import fake_publisher
    from yoda_tpu_torch.api import requests, types
    from yoda_tpu_torch.cluster import fake
    from yoda_tpu_torch.config import SchedulerConfig

    return dict(standalone=standalone, agent=fake_publisher, types=types, fake=fake,
                requests=requests, SchedulerConfig=SchedulerConfig)


def run_pipeline(platform: str, size: dict = PIPELINE_FULL, *, reported: bool = True,
                 mods: "dict | None" = None) -> dict:
    """(l3): ``build_stack`` over a FakeCluster with ``bind_latency_s`` at
    the default 8 workers (so ``bind_pipeline: auto`` pipelines it), the
    fleet of ``size`` and :func:`pipeline_script`'s three waves, each
    drained with ``run_until_idle``; the failing gang's release rolls back
    whole and binds again. ``mods`` (default the port's) picks the
    package, so the tests run the same drive on the reference."""
    m = mods or port_modules()
    waves, fail_key = pipeline_script(size)
    siblings = [f"default/{n}" for n, _ in waves[1] if f"default/{n}" != fail_key]
    cluster = failing_cluster_class(m["fake"].FakeCluster)(
        fail_key=fail_key, siblings=siblings, bind_latency_s=size["latency_s"])
    stack = m["standalone"].build_stack(
        cluster, m["SchedulerConfig"](kernel_platform=platform))
    try:
        agent = m["agent"].FakeTpuAgent(stack.cluster)
        for s in range(size["slices"]):
            agent.add_slice(f"v5p-{s:03d}", generation="v5p", host_topology=(2, 2, 1))
        for h in range(size["v5e_hosts"]):
            agent.add_host(f"v5e-{h:04d}", generation="v5e", chips=8)
        agent.publish_all()
        pipelined = stack.gang.parallel_release and stack.bind_executor.workers == 8
        t0 = time.monotonic()
        for wave in waves:
            for name, labels in wave:
                stack.cluster.create_pod(m["types"].PodSpec(name, labels=dict(labels)))
            stack.scheduler.run_until_idle(max_wall_s=600)
            deadline = time.monotonic() + 60
            while stack.bind_executor.inflight() and time.monotonic() < deadline:
                time.sleep(0.005)
        wall = time.monotonic() - t0
        names = [n for w in waves for n, _ in w]
        bound = {n: stack.cluster.get_pod(f"default/{n}").node_name for n in names}
        gang_of = {n: m["requests"].gang_name_of(lab) for w in waves for n, lab in w}
        gang_hosts: dict = {}
        for n, g in gang_of.items():
            if g is not None:
                gang_hosts.setdefault(g, []).append(bound[n])
        events = event_rows(stack)
        out = dict(
            platform=platform, pods=len(names), pipelined=pipelined,
            bindings={n: v for n, v in bound.items() if gang_of[n] is None},
            gang_hosts={g: sorted(h or "" for h in hs) for g, hs in gang_hosts.items()},
            rollbacks=sorted(k for k, _node in cluster.unbinds),
            failed_binds=cluster.failed, events=events,
            unbound=sorted(n for n, v in bound.items() if v is None),
            overlap_cycles=stack.metrics.overlap_cycles.total(),
            bind_rollbacks=stack.gang.bind_rollbacks, wall_s=wall,
            inflight_after=stack.bind_executor.inflight(),
        )
    finally:
        close_stack(stack)
    return out


def close_stack(stack) -> None:
    """Stop a stack's threads (the reference's Stack has no ``close``)."""
    if hasattr(stack, "close"):
        stack.close()
        return
    stack.gang.close()
    if stack.events is not None:
        stack.events.close()


def check_pipeline_run(run: dict) -> None:
    if not run["pipelined"]:
        raise AssertionError("run (l3): bind_pipeline auto did not pipeline the stack")
    if run["unbound"] or run["inflight_after"]:
        raise AssertionError(f"run (l3): unbound {run['unbound'][:5]}, "
                             f"{run['inflight_after']} binds in flight at the end")
    if run["failed_binds"] != 1 or run["bind_rollbacks"] != 1:
        raise AssertionError(f"run (l3): {run['failed_binds']} injected failures, "
                             f"{run['bind_rollbacks']} gang rollbacks (want 1 and 1)")
    fail_gang = [k for k in run["rollbacks"] if not k.startswith("default/w1-fail-")]
    if fail_gang or not run["rollbacks"]:
        raise AssertionError(f"run (l3): rollbacks {run['rollbacks'][:5]}")


def check_pipeline(g: dict, c: dict) -> None:
    check_pipeline_run(g)
    check_pipeline_run(c)
    diff = [k for k in PIPELINE_PARITY if g[k] != c[k]]
    if diff:
        raise AssertionError(f"run (l3): the card and the CPU differ in {diff}")


def demo_output(argv: "list[str]") -> "tuple[int, str]":
    import contextlib
    import io

    from yoda_tpu_torch import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    return rc, buf.getvalue()


def run_demo_pair() -> dict:
    """(l4): ``--demo`` on the card and ``--demo --device cpu``: the
    placements table (the output before the attempts)."""
    rc_g, out_g = demo_output(["--demo", "-v", "0"])
    rc_c, out_c = demo_output(["--demo", "--device", "cpu", "-v", "0"])
    table = lambda text: text.split("\n\n")[0].splitlines()  # noqa: E731
    return dict(rc=(rc_g, rc_c), card=table(out_g), cpu=table(out_c))


def check_wire_run(run: dict, what: str) -> None:
    bad = {k: v[:5] for k, v in run["checks"].items() if v}
    if bad:
        raise AssertionError(f"{what}: {bad}")
    if run["conflicts"]:
        raise AssertionError(f"{what}: the server answered {run['conflicts']} binds with 409")
    for kernel, n in run["launches"].items():
        if run["kept"].get(kernel, n) != n:
            raise AssertionError(f"{what}: {n} {kernel} launches, {run['kept'][kernel]} held")
    if any(run["max_abs_err"].values()):
        raise AssertionError(f"{what}: a launch differs from its plain version: "
                             f"{run['max_abs_err']}")
    check_no_worker_launch(run, what)


def check_no_worker_launch(run: dict, what: str) -> None:
    """No kernel and no row update launched on a bind-executor worker: the
    pipelined binds and their rollbacks only change host state that the
    serve thread's next dispatch applies."""
    bad = [n for n in run["launch_threads"] if n.startswith("bind-worker")]
    if bad:
        raise AssertionError(f"{what}: launches on bind workers {bad}")


def check_process(l1: dict, l2: dict, card: bool) -> None:
    check_wire_run(l1, "run (l1)")
    if l1["rc"] != 0 or l1["holder"] != "replica-l1":
        raise AssertionError(f"run (l1): rc {l1['rc']}, lease holder {l1['holder']}")
    if l1["pipeline"] != {"parallel_release": True, "workers": 8}:
        raise AssertionError(f"run (l1): the bind pipeline is {l1['pipeline']}")
    if not l1["overlap_cycles"] > 0:
        raise AssertionError("run (l1): yoda_overlap_cycles_total is 0 on /metrics")
    if l1["resyncs"] != 1 or not l1["resync_before_first_pop"]:
        raise AssertionError("run (l1): the resync did not run once before the first pop")
    if card and not (l1["launches"]["fleet_eval"] and l1["launches"]["joint_fit"]):
        raise AssertionError(f"run (l1): kernels not launched: {l1['launches']}")
    check_wire_run(l2, "run (l2)")
    if l2["rc"] != {"a": 0, "b": 0}:
        raise AssertionError(f"run (l2): replicas returned {l2['rc']}")
    if (l2["holder_before"], l2["holder_after"]) != ("replica-a", "replica-b"):
        raise AssertionError(f"run (l2): lease {l2['holder_before']} -> {l2['holder_after']}")
    if l2["standby_readyz"] == 200:
        raise AssertionError("run (l2): the standby answered /readyz 200")
    half = l2["pods"] // 2
    if l2["binds"] != {"a": half, "b": l2["pods"] - half}:
        raise AssertionError(f"run (l2): binds {l2['binds']}")
    if l2["standby_resyncs"] != 1 or not l2["standby_resync_before_first_pop"]:
        raise AssertionError("run (l2): the standby did not resync once before its first pop")
    if card and not l2["launches"]["fleet_eval"]:
        raise AssertionError(f"run (l2): kernels not launched: {l2['launches']}")


def print_process(name: str, run: dict, smi: str) -> None:
    skip = {"bindings", "events", "gang_hosts", "rollbacks", "card", "cpu"}
    print(f"process run ({name}) {run.get('platform', '')} [{smi}]:",
          json.dumps({k: v for k, v in run.items() if k not in skip}, default=str))


def phase_process(smi: str, rerun: "SpawnedRerun", build_s: float) -> dict:
    """Run (l) on the card: (l1)-(l4); (l3) held against its CPU run.
    ``build_s``: the device phase's nvcc build (both kernels, in
    parallel), which the CLI's own device init then finds built."""
    out = {}
    out["l1"] = run_wire("auto")
    out["l1"]["nvcc_build_s"] = build_s
    print_process("l1", out["l1"], smi)
    out["l2"] = run_failover("auto")
    print_process("l2", out["l2"], smi)
    check_process(out["l1"], out["l2"], card=True)
    with KeptKernels() as kept, KeptRowUpdates() as rows:
        g = run_pipeline("auto")
    g.update(kept_counts(kept, rows))
    c = rerun.result()
    print_process("l3", g, smi)
    print_process("l3 cpu", c, smi)
    check_pipeline(g, c)
    check_no_worker_launch(g, "run (l3)")
    if any(g["max_abs_err"].values()) or not g["launches"]["fleet_eval"]:
        raise AssertionError(f"run (l3): launches {g['launches']}, err {g['max_abs_err']}")
    out["l3"] = g
    with KeptKernels() as kept, KeptRowUpdates() as rows:
        demo = run_demo_pair()
    demo.update(kept_counts(kept, rows))
    print_process("l4", demo, smi)
    print("demo on the card:\n  " + "\n  ".join(demo["card"]))
    if demo["rc"] != (0, 0) or demo["card"] != demo["cpu"] or len(demo["card"]) != 6:
        raise AssertionError(f"run (l4): card {demo['card']} vs cpu {demo['cpu']}")
    if any(demo["max_abs_err"].values()) or not demo["launches"]["fleet_eval"]:
        raise AssertionError(f"run (l4): launches {demo['launches']}")
    out["l4"] = demo
    return out


# --- run (m): loop mode ---

# (m1) compares the first ``singles`` of run (a)'s singletons at K = 1 on a
# loop-mode stack and a default stack over the same fleet; (m2) drives
# ``plain`` plain gangs of ``plain_size`` x 8 v5e chips, one topology gang
# (2x2x1, 4 v5p members x 4 chips) and ``singles2`` singletons through a
# loop-mode stack at percentage_nodes_to_score 25. Loop mode filters and
# scores every node in host Python, so the depth is cut to keep the phase
# near a minute on the card's host: (m2)'s plain gangs have 4 members
# where run (c)'s have 16.
LOOP_FULL = dict(slices=512, v5e_hosts=2952, singles=32, plain=4, plain_size=4,
                 singles2=16)
LOOP_SMALL = dict(slices=4, v5e_hosts=40, singles=16, plain=2, plain_size=4,
                  singles2=8)
LOOP_PERCENTAGE = 25


class PhaseClock:
    """Host ms of a framework's per-node filter chain and score plugins,
    per call, wrapped around ``run_filters`` and ``run_scores`` (on a
    stepped scheduling clock the program's own phase histogram reads 0)."""

    def __init__(self, framework) -> None:
        self.filter_ms: list[float] = []
        self.score_ms: list[float] = []
        for name, sink in (("run_filters", self.filter_ms), ("run_scores", self.score_ms)):
            inner = getattr(framework, name)

            def timed(*args, _inner=inner, _sink=sink, **kw):
                t = time.perf_counter()
                try:
                    return _inner(*args, **kw)
                finally:
                    _sink.append(1e3 * (time.perf_counter() - t))

            setattr(framework, name, timed)

    def summary(self) -> dict:
        med = statistics.median
        return dict(
            filter_calls=len(self.filter_ms), score_calls=len(self.score_ms),
            filter_ms_p50=med(self.filter_ms) if self.filter_ms else None,
            score_ms_p50=med(self.score_ms) if self.score_ms else None,
        )


def run_loop_agree(platform: str, size: dict = LOOP_FULL) -> dict:
    """(m1): each of run (a)'s first singletons created in a loop-mode
    stack and in a default stack over the same fleet and scheduled there
    at K = 1 (one pop and one cycle each, state advancing alike); every
    outcome and node must agree, as tests/test_ops.py's
    test_batch_and_loop_agree asserts."""
    from yoda_tpu_torch.api.types import PodSpec
    from yoda_tpu_torch.ops import cuda_kernel

    fleet = dict(slices=size["slices"], v5e_hosts=size["v5e_hosts"])
    loop, _ = build_fleet(platform, 1, mode="loop", **fleet)
    batch, _ = build_fleet(platform, 1, **fleet)
    if loop.batch is not None or loop.not_built or batch.not_built:
        raise AssertionError("run (m1): the stacks are not loop mode and batch mode whole")
    clock = PhaseClock(loop.framework)
    pods = fleet_and_pods(seed=0)[0][: size["singles"]]
    nodes: "dict[str, dict]" = {"loop": {}, "batch": {}}
    cycle_ms: "dict[str, list]" = {"loop": [], "batch": []}
    cuda_kernel.launches = 0
    for name, labels in pods:
        for side, stack in (("loop", loop), ("batch", batch)):
            stack.cluster.create_pod(PodSpec(name, labels=dict(labels)))
            qpi = stack.scheduler.queue.pop(timeout=0)
            if qpi is None or qpi.pod.name != name:
                raise AssertionError(f"run (m1): {side} popped {qpi} for {name}")
            t = time.perf_counter()
            r = stack.scheduler.schedule_one(qpi)
            cycle_ms[side].append(1e3 * (time.perf_counter() - t))
            nodes[side][name] = (r.outcome, r.node)
    if platform != "cpu":
        torch.cuda.synchronize()
    launches = cuda_kernel.launches
    disagree = [p for p in nodes["loop"] if nodes["loop"][p] != nodes["batch"][p]]
    out = dict(
        platform=platform, nodes=len(loop.informer.snapshot()), pods=len(pods),
        bound=sum(o == "bound" for o, _ in nodes["loop"].values()),
        disagree=disagree, loop_nodes=nodes["loop"], batch_nodes=nodes["batch"],
        launches=launches, batch_dispatches=batch.batch.dispatch_count,
        loop_ms_per_pod=statistics.median(cycle_ms["loop"]),
        batch_ms_per_pod=statistics.median(cycle_ms["batch"]),
        **clock.summary(),
    )
    for stack in (loop, batch):
        stack.close()
    return out


def check_loop_agree(run: dict) -> None:
    if run["disagree"]:
        p = run["disagree"][0]
        raise AssertionError(
            f"run (m1): {len(run['disagree'])} pods differ, e.g. {p}: loop "
            f"{run['loop_nodes'][p]} vs batch {run['batch_nodes'][p]}"
        )
    if run["bound"] != run["pods"]:
        raise AssertionError(f"run (m1): {run['bound']}/{run['pods']} pods bound")
    want = run["batch_dispatches"] if run["platform"] != "cpu" else 0
    if run["launches"] != want or (run["platform"] != "cpu" and not want):
        raise AssertionError(
            f"run (m1): {run['launches']} launches for {run['batch_dispatches']} "
            "batch dispatches (the loop stack must launch nothing)"
        )


def loop_gang_script(size: dict, seed: int = 17):
    """(m2)'s pods in a seeded order: (name, labels), and each gang's
    members."""
    rng = np.random.default_rng(seed)
    pods, gangs = [], {}
    for g in range(size["plain"]):
        names = [f"lp{g}-{i}" for i in range(size["plain_size"])]
        gangs[f"lp{g}"] = names
        pods += [(n, {"tpu/gang": f"lp{g}", "tpu/gang-size": str(size["plain_size"]),
                      "tpu/chips": "8", "tpu/generation": "v5e"}) for n in names]
    names = [f"lt-{i}" for i in range(4)]
    gangs["lt"] = names
    pods += [(n, {"tpu/gang": "lt", "tpu/topology": "2x2x1", "tpu/chips": "4",
                  "tpu/generation": "v5p"}) for n in names]
    pods += [(f"ls-{n}", labels) for n, (_, labels) in
             enumerate(fleet_and_pods(seed)[0][: size["singles2"]])]
    return [pods[i] for i in rng.permutation(len(pods))], gangs


def run_loop_gangs(platform: str, size: dict = LOOP_FULL) -> dict:
    """(m2): a loop-mode stack at percentage_nodes_to_score 25 on a held
    scheduling clock (so card and CPU take the same decisions) drains the
    gangs and singletons of :func:`loop_gang_script`; bindings, the checks'
    inputs and host ms per pod, filter call and score call."""
    from yoda_tpu_torch.api.types import PodSpec
    from yoda_tpu_torch.ops import cuda_kernel

    stack, _ = build_fleet(
        platform, 1, slices=size["slices"], v5e_hosts=size["v5e_hosts"],
        clock=SteppedClock(0.0), mode="loop",
        percentage_nodes_to_score=LOOP_PERCENTAGE,
    )
    clock = PhaseClock(stack.framework)
    pods, gangs = loop_gang_script(size)
    for name, labels in pods:
        stack.cluster.create_pod(PodSpec(name, labels=dict(labels)))
    cuda_kernel.launches = 0
    t0 = time.perf_counter()
    stack.scheduler.run_until_idle(max_wall_s=600)
    wall = time.perf_counter() - t0
    bound = {n: stack.cluster.get_pod(f"default/{n}").node_name for n, _ in pods}
    slice_of = {t.name: t.slice_id for t in stack.cluster.list_tpu_metrics()}
    out = dict(
        platform=platform, pods=len(pods), bindings=bound,
        bound=sum(v is not None for v in bound.values()),
        over_capacity=over_capacity(stack), launches=cuda_kernel.launches,
        gangs_split=[g for g, names in gangs.items()
                     if len({bound[n] is None for n in names}) != 1],
        gangs_unbound=[g for g, names in gangs.items() if bound[names[0]] is None],
        topology_slices=sorted({slice_of.get(bound[n]) for n in gangs["lt"]} - {None}),
        waiting=len(stack.framework.waiting_pods()),
        wall_s=wall, ms_per_pod=1e3 * wall / len(pods), **clock.summary(),
    )
    stack.close()
    return out


def check_loop_gangs(run: dict) -> None:
    if run["bound"] != run["pods"] or run["gangs_split"] or run["gangs_unbound"]:
        raise AssertionError(
            f"run (m2) {run['platform']}: {run['bound']}/{run['pods']} bound, "
            f"split {run['gangs_split']}, unbound {run['gangs_unbound']}"
        )
    if run["over_capacity"] or run["waiting"] or run["launches"]:
        raise AssertionError(
            f"run (m2) {run['platform']}: over capacity {run['over_capacity']}, "
            f"{run['waiting']} waiting, {run['launches']} launches"
        )
    if len(run["topology_slices"]) != 1:
        raise AssertionError(f"run (m2): topology gang on slices {run['topology_slices']}")


def run_loop(platform: str, size: dict = LOOP_FULL) -> dict:
    """Run (m): (m1) and (m2) on one platform, each checked."""
    m1 = run_loop_agree(platform, size)
    check_loop_agree(m1)
    m2 = run_loop_gangs(platform, size)
    check_loop_gangs(m2)
    return {"m1": m1, "m2": m2}


def phase_loop(smi: str) -> dict:
    """Run (m) on the card, (m2) also on the CPU: bindings equal."""
    g = run_loop("auto")
    c = run_loop_gangs("cpu")
    check_loop_gangs(c)
    for name, run in (("m1", g["m1"]), ("m2", g["m2"]), ("m2 cpu", c)):
        skip = {"loop_nodes", "batch_nodes", "bindings"}
        print(f"loop run ({name}) {run['platform']} [{smi}]:",
              json.dumps({k: v for k, v in run.items() if k not in skip}))
    if g["m2"]["bindings"] != c["bindings"]:
        diff = [p for p in c["bindings"] if g["m2"]["bindings"][p] != c["bindings"][p]]
        raise AssertionError(f"run (m2): {len(diff)} pods bound differently, e.g. {diff[:3]}")
    return g


# --- run (n): the node-sharded evaluation ---

# (real nodes, padded nodes, chips, K): the main path's K = 1 and K = 16 and
# the wide fleet's 64 chips, each split into 1 and 4 shards of the card.
SHARD_SHAPES = [(5000, 8192, 8, 1), (5000, 8192, 8, 16), (5000, 8192, 64, 16)]
SHARD_SPLITS = (1, 4)
SHARD_MAIN = (8192, 8, 16, 4)  # (padded, chips, K, shards) in the kernels line
# (n2)'s fleet: the 5,000-node fleet; the tests run the small one.
SHARD_FULL = dict(slices=512, v5e_hosts=2952)
SHARD_SMALL = dict(slices=4, v5e_hosts=40)
SHARD_KERNEL = re.compile(r"fleet_eval_shard_kernel<(?:true|false), ?(\d)>")


class PlainShardEntry:
    """Within the block, the sharded kernel's phases run the plain version
    (ops.kernel.kernel_shard_phase) on the card's tensors instead of the
    shard entry: the plain version's time and output on the same inputs.
    It swaps the name ``parallel/sharded.py`` calls."""

    def __enter__(self):
        from yoda_tpu_torch.ops.kernel import kernel_shard_phase
        from yoda_tpu_torch.parallel import sharded

        self.saved = sharded.fleet_eval_shard

        def plain(chips, nodes, dyn, host_ok, reqs, phase, globals_, out, partials,
                  weights, counter=None):
            kernel_shard_phase(chips, nodes, dyn, host_ok, reqs, phase, globals_, out,
                               partials, weights)

        sharded.fleet_eval_shard = plain
        return self

    def __exit__(self, *exc):
        from yoda_tpu_torch.parallel import sharded

        sharded.fleet_eval_shard = self.saved


def shard_inputs(n_real: int, n_pad: int, c: int, k: int):
    """Seeded fleet, admission rows (the last all-False when K > 1) and
    requests, as phase_kernel makes them."""
    from yoda_tpu_torch.ops.kernel import KernelRequest

    chips, nodes, dyn = random_fleet(n_real, n_pad, seed=n_pad + k + c + 7, chips=c)
    rng = np.random.default_rng(k + 7)
    host_ok = (rng.random((k, n_pad)) > 0.2).astype(np.int32)
    if k > 1:
        host_ok[-1] = 0
    reqs = [KernelRequest(*map(int, r)) for r in REQUEST_TABLE[np.arange(k) % 4]]
    return fleet_arrays(chips, nodes, dyn), dyn, host_ok, reqs


def results_err(got, want) -> int:
    """Largest |difference| over every output row of two result lists."""
    err = 0
    for g, w in zip(got, want, strict=True):
        for f in ("feasible", "reasons", "raw_scores", "scores", "claimable"):
            a = np.asarray(getattr(g, f), dtype=np.int64)
            b = np.asarray(getattr(w, f), dtype=np.int64)
            err = max(err, int(np.abs(a - b).max()) if a.size else 0)
        err = max(err, abs(g.best_index - w.best_index))
    return err


def shard_profile(fn, calls: int = 20) -> dict:
    """Device ms per call of each phase's shard-entry kernels and of the
    other device work (the combines and partial fills), from a
    torch.profiler window over ``calls`` calls; None where the profiler
    saw no device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    phase_us, events, other_us, other = {1: 0.0, 2: 0.0, 3: 0.0}, 0, 0.0, 0
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA or evt.key.startswith("Memcpy"):
            continue
        total = getattr(evt, "self_device_time_total", None)
        if total is None:
            total = evt.self_cuda_time_total
        m = SHARD_KERNEL.search(evt.key)
        if m:
            phase_us[int(m.group(1))] += total
            events += evt.count
        else:
            other_us += total
            other += evt.count
    if not events:
        return dict(phase_ms=None, device_ms=None, combine_ms=None, kernel_events=0)
    return dict(
        phase_ms={p: us / calls / 1e3 for p, us in phase_us.items()},
        device_ms=sum(phase_us.values()) / calls / 1e3,
        combine_ms=other_us / calls / 1e3,
        kernel_events_per_call=events / calls, other_events_per_call=other / calls,
    )


def shard_case(n_real: int, n_pad: int, c: int, k: int, shards: int, weights,
               dev: torch.device, timed: bool) -> dict:
    """One shape and split: the shard entry on ``shards`` shards of ``dev``
    against the unsharded ``fleet_eval`` and against the plain shard
    version (on host shards, and on the card's tensors), bit for bit; with
    ``timed`` the times, device ms per phase and the bound."""
    from yoda_tpu_torch.ops import cuda_kernel
    from yoda_tpu_torch.ops.kernel import TorchFleetKernel
    from yoda_tpu_torch.parallel import ShardedDeviceFleetKernel

    fa, dyn, host_ok, reqs = shard_inputs(n_real, n_pad, c, k)
    single = TorchFleetKernel(weights, dev)
    single.put_static(fa)
    want = single.evaluate_burst(dyn, host_ok, reqs)
    kern = ShardedDeviceFleetKernel(weights, mesh=[dev] * shards)
    kern.put_static(fa)
    got = kern.evaluate_burst(dyn, host_ok, reqs)
    host = ShardedDeviceFleetKernel(weights, mesh=[torch.device("cpu")] * shards)
    host.put_static(fa)
    plain = host.evaluate_burst(dyn, host_ok, reqs)
    with PlainShardEntry():
        plain_card = kern.evaluate_burst(dyn, host_ok, reqs)
    torch.cuda.synchronize()
    row = dict(
        padded=n_pad, chips=c, k=k, shards=shards,
        max_abs_err=max(results_err(got, want), results_err(got, plain),
                        results_err(got, plain_card)),
        err_vs_unsharded=results_err(got, want), err_vs_plain=results_err(got, plain),
        launches_per_call=kern.shard_launches,
        expected_launches=3 * shards * -(-k // cuda_kernel.MAX_REQUESTS),
    )
    if timed:
        staged = kern.stage(dyn, host_ok, reqs)
        row["ms"] = cuda_ms(lambda: kern.run_phases(staged, k))
        with PlainShardEntry():
            row["plain_ms"] = cuda_ms(lambda: kern.run_phases(staged, k), iters=5)
        if shards == 1:  # the same inputs through the one-launch evaluation
            row["unsharded_ms"] = cuda_ms(
                lambda: cuda_kernel.fleet_eval(kern._chips[0], kern._nodes[0], *staged[0],
                                               weights)
            )
        row.update(shard_profile(lambda: kern.run_phases(staged, k)))
        row["bound_ms"], row["bound_by"] = bound(n_pad, k, c)
        row["smi"] = smi_sample()
    return row


def run_sharded_stack(platform: str, size: dict, pods, burst: int = 16) -> dict:
    """(n2): a ``mesh_devices: 1`` stack drains ``pods`` at K = ``burst``;
    every sharded evaluation is held against the unsharded plain version
    on the same inputs (the shards' static state gathered on the host),
    with every count zeroed just before the drive."""
    from yoda_tpu_torch.api.types import PodSpec
    from yoda_tpu_torch.ops import cuda_kernel
    from yoda_tpu_torch.ops.kernel import kernel_packed_burst, pack_request
    from yoda_tpu_torch.parallel import ShardedDeviceFleetKernel

    stack, _ = build_fleet(platform, burst, slices=size["slices"],
                           v5e_hosts=size["v5e_hosts"], mesh_devices=1)
    kern = stack.batch._kern
    if not isinstance(kern, ShardedDeviceFleetKernel) or stack.not_built:
        raise AssertionError("run (n2): the stack does not hold the sharded kernel")
    checked = {"calls": 0, "max_abs_err": 0}
    inner = kern.evaluate_burst

    def held(dyn, host_ok_k, requests):
        got = inner(dyn, host_ok_k, requests)
        chips = torch.cat([c.cpu() for c in kern._chips], dim=2)
        nodes = torch.cat([n.cpu() for n in kern._nodes], dim=1)
        want = kernel_packed_burst(
            chips, nodes, torch.from_numpy(np.asarray(dyn, dtype=np.int32)),
            torch.from_numpy(np.asarray(host_ok_k, dtype=np.int32)),
            torch.from_numpy(np.stack([pack_request(r) for r in requests])),
            kern.weights,
        ).numpy()
        n = len(kern.names)
        for i, g in enumerate(got):
            rows = np.stack([g.feasible.astype(np.int32), g.reasons, g.raw_scores,
                             g.scores, g.claimable])
            diff = np.abs(rows.astype(np.int64) - want[i][[0, 1, 2, 3, 5], :n]).max()
            best = int(want[i][4][0])
            checked["max_abs_err"] = max(
                checked["max_abs_err"], int(diff),
                abs(g.best_index - (best if 0 <= best < n else -1)),
            )
        checked["calls"] += 1
        return got

    kern.evaluate_burst = held
    for name, labels in pods:
        stack.cluster.create_pod(PodSpec(name, labels=dict(labels)))
    cuda_kernel.launches = cuda_kernel.shard_launches = 0
    t0 = time.perf_counter()
    stack.scheduler.run_until_idle(max_wall_s=600)
    if platform != "cpu":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    bound_nodes = {n: stack.cluster.get_pod(f"default/{n}").node_name for n, _ in pods}
    b = stack.batch
    out = dict(
        platform=platform, pods=len(pods), bindings=bound_nodes,
        bound=sum(v is not None for v in bound_nodes.values()),
        over_capacity=over_capacity(stack), shard_launches=cuda_kernel.shard_launches,
        fleet_eval_launches=cuda_kernel.launches, dispatch_count=b.dispatch_count,
        sharded_dispatches=b.sharded_dispatches, burst_dispatches=b.burst_dispatches,
        checked_calls=checked["calls"], max_abs_err=checked["max_abs_err"],
        restacks=b.restacks, wall_s=wall, pods_per_s=len(pods) / wall,
    )
    stack.close()
    return out


def check_sharded_stack(run: dict, want_bindings: dict) -> None:
    card = run["platform"] != "cpu"
    if run["bindings"] != want_bindings:
        diff = [p for p in want_bindings if run["bindings"].get(p) != want_bindings[p]]
        raise AssertionError(f"run (n2): {len(diff)} pods bound unlike the default stack, "
                             f"e.g. {diff[:3]}")
    if run["bound"] != run["pods"] or run["over_capacity"] or run["max_abs_err"]:
        raise AssertionError(f"run (n2): {json.dumps({k: v for k, v in run.items() if k != 'bindings'})}")
    if run["sharded_dispatches"] != run["dispatch_count"] or not run["dispatch_count"]:
        raise AssertionError("run (n2): a dispatch left the mesh kernel")
    if run["checked_calls"] < run["dispatch_count"] or run["fleet_eval_launches"]:
        raise AssertionError("run (n2): unchecked evaluations or a fleet_eval launch")
    if card and not run["shard_launches"]:
        raise AssertionError("run (n2): the shard entry was launched no time")
    if not card and run["shard_launches"]:
        raise AssertionError("run (n2): the CPU run launched the shard entry")


def mesh_refused() -> str:
    """(n3): ``mesh_devices: 2`` on one card raises at construction."""
    from yoda_tpu_torch.config import SchedulerConfig
    from yoda_tpu_torch.standalone import build_stack

    try:
        build_stack(config=SchedulerConfig(mesh_devices=torch.cuda.device_count() + 1))
    except ValueError as e:
        if "devices are available" not in str(e):
            raise
        return str(e)
    raise AssertionError("run (n3): a mesh larger than the card count was built")


def phase_sharded(smi: str, main_path: dict) -> dict:
    """Run (n): (n1) the shard entry against the unsharded kernel and the
    plain version at SHARD_SHAPES x SHARD_SPLITS; (n2) a ``mesh_devices:
    1`` stack binds run (b)'s pods as the default stack did in the main
    path; (n3) a mesh past the card count is refused."""
    from yoda_tpu_torch.config import SchedulerConfig

    dev = torch.device("cuda", 0)
    weight_sets = {
        "least-allocated": SchedulerConfig().effective_weights(),
        "most-allocated": SchedulerConfig(scoring_strategy="most-allocated").effective_weights(),
    }
    rows = []
    for n_real, n_pad, c, k in SHARD_SHAPES:
        for shards in SHARD_SPLITS:
            for wname, w in weight_sets.items():
                row = shard_case(n_real, n_pad, c, k, shards, w, dev,
                                 timed=wname == "least-allocated")
                row["weights"] = wname
                print("shard", json.dumps(row, default=str))
                if row["max_abs_err"] or row["launches_per_call"] != row["expected_launches"]:
                    raise AssertionError(f"run (n1): shard entry != reference at {row}")
                rows.append(row)
    pods_b = fleet_and_pods(seed=0)[1]
    n2 = run_sharded_stack("auto", SHARD_FULL, pods_b)
    print(f"sharded run (n2) [{smi}]:",
          json.dumps({k: v for k, v in n2.items() if k != "bindings"}))
    check_sharded_stack(n2, main_path["b"]["bindings"])
    refused = mesh_refused()
    print(f"sharded run (n3): {refused}")
    main = next(r for r in rows if r.get("ms") is not None
                and (r["padded"], r["chips"], r["k"], r["shards"]) == SHARD_MAIN)
    return dict(rows=rows, n2=n2, refused=refused, main=main)


# --- run (o): scheduler lanes, the durable journal and profiles ------------

# Run (o) at the 5,000-node fleet with the shipped manifest's recommended
# shard_count (deploy/yoda-tpu-scheduler.yaml: "Raise to 2-4"); the small
# size is what tests/test_torch_shards.py runs on the CPU.
# ``nojournal``: (o2) also runs with the journal off; ``single``: (o2) also
# runs as one stack. Both cut at the full size (PERF.md section 4): the
# comparisons are recorded, and runs (q) and (r) needed the time.
# ``wall_waves``: the waves (o2) drives; its second wave is cut at the full
# size for run (r) (the first holds the global lane's wide gang and every
# lane's singletons).
LANES_FULL = dict(slices=512, v5e_hosts=2952, shards=4, singles_b=256, script={},
                  nojournal=False, single=False, wall_waves=1)
LANES_SMALL = dict(slices=16, v5e_hosts=96, shards=4, singles_b=32,
                   script=dict(plain=2, plain_size=4, cosched=2, topo=4, multi=1,
                               singles=16), nojournal=True, single=True, wall_waves=2)
O2_PARTS = ("o2", "o2_single", "o2_nojournal")
PACK_PROFILE = "yoda-tpu-pack"   # run (o4)'s second profile: most-allocated
# (o2)'s Permit timeout: a gang whose planned hosts another lane took
# waits this long before it rejoins the queue whole (the default, 120 s,
# would set the drive's wall and its p99).
O2_PERMIT_TIMEOUT_S = 15.0
LANE_RUN_DIR = "build/run_o"
O1_PARITY = ("routes", "lanes", "bindings", "commits", "conflicts", "rollbacks",
             "staged", "journal")
O3_PARITY = ("bindings", "lanes", "replayed_claims", "replayed_gangs", "warm",
             "residue", "commits", "conflicts", "staged", "journal")
O4_PARITY = ("bindings", "profiles")


def lane_waves(size: dict):
    """Run (o)'s two waves of (name, labels, selector) and every gang's
    (kind, size): run (c)'s two gang waves, run (b)'s singletons split over
    them, and in the first wave one plain v5e gang of 8-chip members one
    larger than any lane's v5e hosts, which only the global lane can host."""
    from yoda_tpu_torch.framework.shards import ShardMap

    waves, gangs = gang_script(seed=1, **size["script"])
    singles = fleet_and_pods(seed=0)[1][: size["singles_b"]]
    half = len(singles) // 2
    waves[0] = waves[0] + [(f"b{n}", dict(labels), None) for n, labels in singles[:half]]
    waves[1] = waves[1] + [(f"b{n}", dict(labels), None) for n, labels in singles[half:]]
    smap = ShardMap(size["shards"])
    per_lane: dict[int, int] = {}
    for h in range(size["v5e_hosts"]):
        lane = smap.shard_of_pool(f"host:v5e-{h:04d}")
        per_lane[lane] = per_lane.get(lane, 0) + 1
    wide = max(per_lane.values()) + 1
    gangs["wide"] = ("plain", wide)
    labels = {"tpu/gang": "wide", "tpu/gang-size": str(wide), "tpu/chips": "8",
              "tpu/generation": "v5e"}
    waves[0] = [(f"wide-{i:03d}", dict(labels), None) for i in range(wide)] + waves[0]
    return waves, gangs


def lane_config(platform: str, size: dict, journal_dir, **knobs):
    from yoda_tpu_torch.config import SchedulerConfig

    return SchedulerConfig(
        kernel_platform=platform, batch_requests=16, shard_count=size["shards"],
        journal_path=str(journal_dir) if journal_dir else "",
        journal_sync="batch", **knobs,
    )


def lane_dir(platform: str, what: str):
    """A fresh directory under the checkout's build/ for one run's journal."""
    import os
    import shutil
    from pathlib import Path

    d = Path(LANE_RUN_DIR) / f"{what}-{platform}-{os.getpid()}"
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    return d


def publish_fleet(cluster, size: dict, now_fn=None):
    from yoda_tpu_torch.agent.fake_publisher import FakeTpuAgent

    agent = FakeTpuAgent(cluster, **({} if now_fn is None else {"now_fn": now_fn}))
    for s in range(size["slices"]):
        agent.add_slice(f"v5p-{s:03d}", generation="v5p", host_topology=(2, 2, 1))
    for h in range(size["v5e_hosts"]):
        agent.add_host(f"v5e-{h:04d}", generation="v5e", chips=8)
    agent.publish_all()
    return agent


def create_wave(cluster, wave, routes=None, router=None) -> None:
    """Each pod with its own name as uid (a singleton routes on its uid,
    which must not depend on what else the process built before)."""
    from yoda_tpu_torch.api.types import PodSpec

    for name, labels, selector in wave:
        pod = PodSpec(name, labels=dict(labels), node_selector=selector or {},
                      uid=f"default/{name}")
        if routes is not None:
            routes[name] = router.route(pod)
        cluster.create_pod(pod)


def track_lanes(stacks, bound_lane: dict) -> None:
    """Record which lane (or profile) bound each pod, at the bind."""
    for st in stacks:
        lane = st.scheduler.shard or st.informer.scheduler_name
        real = st.scheduler.on_bound

        def on_bound(pod, node, _real=real, _lane=lane):
            bound_lane[pod.name] = _lane
            if _real is not None:
                _real(pod, node)

        st.scheduler.on_bound = on_bound


class BindLog:
    """Every binding POST and unbind through the cluster: ``double`` lists
    each pod a bind reached while the pod was bound (a rolled-back gang's
    member bound again after its unbind is not one)."""

    def __init__(self, cluster) -> None:
        self.binds = 0
        self.double: list = []
        self._bound: dict = {}
        self._lock = threading.Lock()
        real_bind, real_unbind = cluster.bind_pod, cluster.unbind_pod

        def bind_pod(key, node):
            with self._lock:
                if key in self._bound:
                    self.double.append(key)
            out = real_bind(key, node)
            with self._lock:
                self._bound[key] = node
                self.binds += 1
            return out

        def unbind_pod(key, node):
            real_unbind(key, node)
            with self._lock:
                if self._bound.get(key) == node:
                    del self._bound[key]

        cluster.bind_pod, cluster.unbind_pod = bind_pod, unbind_pod


def drain_stepped(stacks, clock, shard_set=None, rounds: int = 12) -> None:
    """Drive every lane's (or profile's) run_until_idle in a fixed order on
    the held clock, a second of it per round, until a round binds nothing
    and moves nothing (ShardSet.run_until_idle's fixed point, lane after
    lane instead of on threads)."""
    last = -1
    for _ in range(rounds):
        moved = shard_set.rescue_starved(min_attempts=1) if shard_set else 0
        for st in stacks:
            st.scheduler.run_until_idle(max_wall_s=600)
        moved += shard_set.rescue_starved(min_attempts=1) if shard_set else 0
        binds = sum(st.scheduler.stats.binds for st in stacks)
        parked = any(st.queue.has_parked() for st in stacks)
        if moved == 0 and (not parked or binds == last):
            return
        last = binds
        clock.advance(1.0)
        for st in stacks:
            st.framework.expire_waiting(now=clock())
            if st.queue.has_parked():
                st.queue.move_all_to_active(force=True)


def journal_bytes(d) -> dict:
    return {p.name: p.read_bytes() for p in sorted(d.iterdir())}


def lane_state(ss, pods, bound_lane, routes) -> dict:
    cluster = ss.global_stack.cluster
    capacity = {t.name: len(t.healthy_chips()) for t in cluster.list_tpu_metrics()}
    return dict(
        routes=dict(routes),
        lanes={n: bound_lane.get(n) for n in pods},
        bindings=bindings_of(ss.global_stack, pods),
        commits=ss.accountant.commit_commits,
        conflicts=ss.accountant.commit_conflicts,
        rollbacks=ss.metrics.shard_rollbacks.total(),
        staged=sorted(ss.accountant.staged_uids()),
        overcommitted=[h for h, cap in capacity.items()
                       if ss.accountant.chips_in_use(h) > cap],
    )


def lane_launches(stacks) -> dict:
    """Each lane's (or profile's) own launches: its batch kernel's and its
    speculation kernel's (the counts the wrappers bump through
    ``counter=``)."""
    out = {}
    for st in stacks:
        lane = st.scheduler.shard or st.informer.scheduler_name
        k, spec = st.batch._kern, st.speculation.kernel
        out[lane] = dict(fleet_eval=k.launches + spec.launches,
                         joint_fit=k.joint_fit_launches,
                         update_rows=k.row_updates + spec.row_updates)
    return out


def gangs_whole(bindings: dict, gangs: dict) -> list:
    """The gangs bound in part (some members bound, some not)."""
    split = []
    for g, (_kind, n) in gangs.items():
        got = sum(1 for name, node in bindings.items()
                  if name.startswith(f"{g}-") and node not in (None, "evicted"))
        if got not in (0, n):
            split.append((g, got, n))
    return split


def run_lanes_stepped(platform: str, size: dict) -> "tuple[dict, dict]":
    """(o1) and (o3), one drive on a held clock, lane after lane. (o1):
    ``build_sharded_stacks`` with ``shard_count`` lanes and the journal
    (``journal_sync: batch``) binds the first wave. (o3) goes on from
    there: with every lane's commit cut off, one topology gang of the
    second wave binds on its lane (its claims left STAGED in the journal:
    the bound residue) and two members of another park at Permit (staged,
    unbound); the set is dropped without ``close`` (its journal detached
    and its watchers gone, as a dead process's); a new set over the same
    cluster and journal replays, resyncs warm before any bind, commits the
    residue in a drift pass and binds the rest of the second wave. The
    bindings, lanes, commits and the journal files cover both sets; every
    launch of each set is kept and held against the plain versions."""
    from yoda_tpu_torch.cluster.fake import FakeCluster
    from yoda_tpu_torch.standalone import build_sharded_stacks

    waves, gangs = lane_waves(size)
    d = lane_dir(platform, "o1")
    clock = SteppedClock(1000.0)
    cfg = lane_config(platform, size, d)
    kept_a, kept_b = KeptKernels(), KeptKernels()
    kept_a.install()
    try:
        t0 = time.monotonic()
        cluster = FakeCluster()
        n_watchers = len(cluster._watchers)
        a = build_sharded_stacks(cluster, cfg, clock=clock)
        publish_fleet(cluster, size)
        binds = BindLog(cluster)
        bound_lane: dict = {}
        routes: dict = {}
        track_lanes(a.stacks, bound_lane)
        create_wave(cluster, waves[0], routes, a.router)
        drain_stepped(a.stacks, clock, a)
        wall = time.monotonic() - t0
        a_state = dict(
            lane_launches=lane_launches(a.stacks),
            restacks={st.scheduler.shard: (st.batch.restacks,
                                           st.batch._resident.last_restack_ms)
                      for st in a.stacks},
            partition={st.scheduler.shard: len(st.informer.snapshot()) for st in a.stacks},
        )
        # Two topology gangs of the second wave on shard lanes: the first
        # binds whole with its commit cut off, the second parks half.
        topo = sorted({labels["tpu/gang"] for _, labels, _ in waves[1]
                       if "tpu/topology" in labels and "tpu/multislice" not in labels})
        lanes = {st.scheduler.shard: st for st in a.stacks}
        residue_gang, parked_gang = [
            g for g in topo if a.router.route(_probe_pod(waves[1], g)) != "global"][:2]
        for st in a.stacks:
            st.scheduler.commit_fn = lambda uids: (True, "")
        first = [w for w in waves[1] if w[1].get("tpu/gang") == residue_gang]
        create_wave(cluster, first, routes, a.router)
        lanes[routes[first[0][0]]].scheduler.run_until_idle(max_wall_s=600)
        half = [w for w in waves[1] if w[1].get("tpu/gang") == parked_gang][:2]
        create_wave(cluster, half, routes, a.router)
        # Cycle by cycle: run_until_idle would wait out its wall time
        # behind the half gang's Permit barrier.
        parked = lanes[routes[half[0][0]]]
        while (qpi := parked.queue.pop(timeout=0.0)) is not None:
            for q in parked.scheduler._pop_batch(qpi):
                parked.scheduler.schedule_one(q)
        if len(parked.framework.waiting_pods()) != 2:
            raise AssertionError(
                f"(o3): {len(parked.framework.waiting_pods())} members parked at Permit")
        staged_at_crash = len(a.accountant.staged_uids())
        if platform != "cpu":
            torch.cuda.synchronize()
    finally:
        kept_a.restore()
    # The crash: the journal's writer and every watch stream of the dead
    # process end; nothing is closed.
    journal_a = a.accountant.journal
    a.accountant.journal = None
    journal_a.close()
    del cluster._watchers[n_watchers:]
    kept_b.install()
    try:
        b = build_sharded_stacks(cluster, cfg, clock=clock)
        track_lanes(b.stacks, bound_lane)
        replayed = b.accountant.replayed
        replayed_claims = len(b.accountant.claims_snapshot())
        replayed_gangs = {g: len(u) for g, u in b.accountant.replayed_gangs.items()}
        binds_before_resync = binds.binds
        report = b.global_stack.reconciler.resync()
        binds_at_resync = binds.binds
        b.reroute()
        bound_uids = {p.uid for p in cluster.list_pods() if p.node_name}
        residue = sorted(u for u in b.accountant.staged_uids() if u in bound_uids)
        b.global_stack.reconciler.reconcile(relist=False)
        residue_left = sorted(u for u in b.accountant.staged_uids() if u in bound_uids)
        done = {n for n, _, _ in first + half}
        create_wave(cluster, [w for w in waves[1] if w[0] not in done], routes, b.router)
        drain_stepped(b.stacks, clock, b)
        if platform != "cpu":
            torch.cuda.synchronize()
    finally:
        kept_b.restore()
    b.accountant.journal.close()
    pods = [n for w in waves for n, _, _ in w]
    state = lane_state(b, pods, bound_lane, routes)
    summary = b.accountant.journal.summary()
    split = gangs_whole(state["bindings"], gangs)
    o1 = dict(
        state, platform=platform, pods=len(pods), gangs=gangs, wall_s=wall,
        bound=sum(v not in (None, "evicted") for v in state["bindings"].values()),
        split=split, double_binds=sorted(binds.double),
        commits=a.accountant.commit_commits + b.accountant.commit_commits,
        conflicts=a.accountant.commit_conflicts + b.accountant.commit_conflicts,
        rollbacks=a.metrics.shard_rollbacks.total() + b.metrics.shard_rollbacks.total(),
        journal=journal_bytes(d), journal_summary=journal_a.summary(),
        kernels=kept_a.errors() if platform != "cpu" else None,
        **a_state,
    )
    o3 = dict(
        platform=platform, pods=len(pods), bindings=state["bindings"],
        lanes=state["lanes"], bound=o1["bound"], split=split,
        overcommitted=state["overcommitted"], double_binds=o1["double_binds"],
        staged_at_crash=staged_at_crash, replayed=replayed,
        replayed_claims=replayed_claims, replayed_gangs=replayed_gangs,
        warm=report.warm, binds_before_resync=binds_before_resync,
        binds_at_resync=binds_at_resync, residue=residue, residue_left=residue_left,
        commits=b.accountant.commit_commits, conflicts=b.accountant.commit_conflicts,
        staged=state["staged"], replay_ms=summary["replay_ms"],
        records=summary["tail_seq"], journal_size=summary["size_bytes"],
        fsyncs=summary["fsyncs"], journal=o1["journal"],
        residue_gang=residue_gang, parked_gang=parked_gang,
        lane_launches=lane_launches(b.stacks),
        kernels=kept_b.errors() if platform != "cpu" else None,
    )
    # The dead set's threads, which its crash left running.
    for st in a.stacks + b.stacks:
        st.close()
    return o1, o3


def _probe_pod(wave, gang: str):
    from yoda_tpu_torch.api.types import PodSpec

    name, labels, _ = next(w for w in wave if w[1].get("tpu/gang") == gang)
    return PodSpec(name, labels=dict(labels), uid=f"default/{name}")


def run_profiles(platform: str, size: dict) -> dict:
    """(o4): ``build_profile_stacks`` with the base profile (least-allocated)
    and ``yoda-tpu-pack`` (most-allocated) over one accountant and one
    cycle lock: run (b)'s singletons alternate between the two names and
    each profile gets run (c)'s topology gangs of one wave, drained profile
    by profile on a held clock."""
    from yoda_tpu_torch.cluster.fake import FakeCluster
    from yoda_tpu_torch.config import SchedulerConfig
    from yoda_tpu_torch.standalone import build_profile_stacks

    waves, gangs = gang_script(seed=1, **size["script"])
    singles = fleet_and_pods(seed=0)[1][: size["singles_b"]]
    pods = [(f"b{n}", dict(labels), None) for n, labels in singles]
    pods += [w for w in waves[1] if "tpu/multislice" not in w[1]
             and "tpu/topology" in w[1]]
    names = ("yoda-tpu", PACK_PROFILE)
    config = SchedulerConfig(
        kernel_platform=platform, batch_requests=16,
        profiles=(SchedulerConfig(scheduler_name=PACK_PROFILE, kernel_platform=platform,
                                  batch_requests=16, scoring_strategy="most-allocated"),),
    )
    clock = SteppedClock(1000.0)
    kept = KeptKernels()
    kept.install()
    try:
        cluster = FakeCluster()
        stacks = build_profile_stacks(cluster, config, clock=clock)
        publish_fleet(cluster, size)
        binds = BindLog(cluster)
        bound_lane: dict = {}
        track_lanes(stacks, bound_lane)
        from yoda_tpu_torch.api.requests import gang_name_of
        from yoda_tpu_torch.api.types import PodSpec

        for i, (name, labels, _sel) in enumerate(pods):
            g = gang_name_of(labels)
            which = (sorted(gangs).index(g) if g else i) % 2
            cluster.create_pod(PodSpec(name, labels=dict(labels), uid=f"default/{name}",
                                       scheduler_name=names[which]))
        t0 = time.monotonic()
        drain_stepped(stacks, clock)
        if platform != "cpu":
            torch.cuda.synchronize()
        wall = time.monotonic() - t0
    finally:
        kept.restore()
    names_of = [n for n, _, _ in pods]
    bindings = bindings_of(stacks[0], names_of)
    capacity = {t.name: len(t.healthy_chips()) for t in cluster.list_tpu_metrics()}
    out = dict(
        platform=platform, pods=len(pods), wall_s=wall, bindings=bindings,
        profiles={n: bound_lane.get(n) for n in names_of},
        bound=sum(v not in (None, "evicted") for v in bindings.values()),
        split=gangs_whole(bindings, {g: v for g, v in gangs.items()
                                     if any(n.startswith(f"{g}-") for n in names_of)}),
        overcommitted=[h for h, c in capacity.items()
                       if stacks[0].accountant.chips_in_use(h) > c],
        double_binds=sorted(binds.double),
        shared=(len({id(st.accountant) for st in stacks}) == 1
                and len({id(st.scheduler.cycle_lock) for st in stacks}) == 1),
        lane_launches=lane_launches(stacks),
        kernels=kept.errors() if platform != "cpu" else None,
    )
    for st in stacks:
        st.close()
    return out


def run_lanes_wall(platform: str, size: dict, *, shards: int, journal: bool,
                   profiled: bool = False) -> dict:
    """(o2): every lane's ``serve_forever`` on a thread of its own (the
    CLI's wiring: the global lane resyncs and reroutes before its first
    pop, the shard lanes wait for that resync, the global lane's
    rebalancer ticks its speculation, the shard set's rescue pass runs),
    speculation on, on the wall clock over (o1)'s pods, wave after wave
    (the first ``wall_waves`` of them), at a Permit timeout of
    ``O2_PERMIT_TIMEOUT_S``.
    ``shards`` 1 builds one plain stack for the same script. With
    ``profiled`` a torch.profiler window (CUDA activity only) covers the
    drive and counts the kernel records that overlap one on another
    stream."""
    from yoda_tpu_torch.config import SchedulerConfig
    from yoda_tpu_torch.standalone import build_sharded_stacks, build_stack

    waves, gangs = lane_waves(size)
    waves = waves[: size["wall_waves"]]
    gangs = {g: v for g, v in gangs.items()
             if any(n.startswith(f"{g}-") for w in waves for n, _, _ in w)}
    d = lane_dir(platform, f"o2-{shards}-{int(journal)}") if journal else None
    cfg = lane_config(platform, size, d, gang_permit_timeout_s=O2_PERMIT_TIMEOUT_S)
    if shards > 1:
        ss = build_sharded_stacks(config=cfg)
        stacks, cluster = ss.stacks, ss.global_stack.cluster
    else:
        ss = None
        st = build_stack(config=dataclasses.replace(cfg, shard_count=1))
        stacks, cluster = [st], st.cluster
    publish_fleet(cluster, size)
    binds = BindLog(cluster)
    bound_lane: dict = {}
    track_lanes(stacks, bound_lane)
    pods = [n for w in waves for n, _, _ in w]
    stop = threading.Event()
    g = stacks[0]
    if ss is not None:
        def serve_start(rec=g.reconciler, s=ss):
            rec.resync()
            s.reroute()

        g.scheduler.on_serve_start = serve_start
        for st in stacks[1:]:
            st.scheduler.fence_fn = g.reconciler.resynced.is_set
    else:
        g.scheduler.on_serve_start = g.reconciler.resync
    threads = [threading.Thread(target=st.scheduler.serve_forever, args=(stop,),
                                kwargs={"poll_s": 0.05}, daemon=True,
                                name=f"lane-{st.scheduler.shard or 'single'}")
               for st in stacks]
    threads.append(threading.Thread(
        target=g.rebalancer.run_forever, args=(stop,),
        kwargs={"period_s": 3600.0, "spec_period_s": 0.05}, daemon=True,
        name="rebalance-global"))
    if ss is not None:
        threads.append(threading.Thread(target=ss.run_forever, args=(stop,),
                                        kwargs={"period_s": 0.5}, daemon=True,
                                        name="shard-maintenance"))
    kept = KeptKernels()
    prof = None
    if profiled and platform != "cpu":
        from torch.profiler import ProfilerActivity, profile

        prof = profile(activities=[ProfilerActivity.CUDA])
    for st in stacks:  # every count zeroed just before the drive
        st.batch._kern.launches = st.batch._kern.joint_fit_launches = 0
        st.batch._kern.row_updates = 0
        st.speculation.kernel.launches = st.speculation.kernel.row_updates = 0
    kept.install()
    if prof is not None:
        prof.__enter__()
    created: dict = {}
    try:
        t0 = time.monotonic()
        for t in threads:
            t.start()
        for wave in waves:
            t_wave = time.monotonic()
            create_wave(cluster, wave)
            for n, _, _ in wave:
                created[n] = t_wave
            # Bound and committed: a gang whose commit conflicts with an
            # earlier-staged claim of another lane is unbound after its
            # binds landed, so nothing may stay staged around the check.
            wait_for(lambda w=wave: all(
                cluster.get_pod(f"default/{n}").node_name for n, _, _ in w)
                and g.accountant.staged_count() == 0,
                600.0, "every pod of the wave bound and committed", poll_s=0.05)
        wall = time.monotonic() - t0
        if platform != "cpu":
            torch.cuda.synchronize()
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=60)
        if prof is not None:
            prof.__exit__(None, None, None)
        kept.restore()
    bindings = bindings_of(g, pods)
    lat, completion = bind_latencies(
        [r for st in stacks for r in st.scheduler.stats.results],
        {n: labels for w in waves for n, labels, _ in w}, bindings)
    capacity = {t.name: len(t.healthy_chips()) for t in cluster.list_tpu_metrics()}
    claims = g.accountant.claims_snapshot()
    bound_claims = {p.uid: (p.node_name, int(p.labels.get("tpu/chips", 1)))
                    for p in cluster.list_pods() if p.node_name}
    out = dict(
        platform=platform, shards=shards, journal=journal, pods=len(pods),
        bound=sum(v not in (None, "evicted") for v in bindings.values()),
        wall_s=wall, pods_per_s=len(pods) / wall if wall else 0.0,
        p50_ms=pct_ms(lat, 0.5), p99_ms=pct_ms(lat, 0.99),
        gang_p50_ms=pct_ms(completion, 0.5), gang_p99_ms=pct_ms(completion, 0.99),
        split=gangs_whole(bindings, gangs),
        overcommitted=[h for h, c in capacity.items() if g.accountant.chips_in_use(h) > c],
        double_binds=sorted(binds.double),
        claims_equal_bound=claims == bound_claims,
        alive=[t.name for t in threads if t.is_alive()],
        lane_launches=lane_launches(stacks),
        lanes=sorted({v for v in bound_lane.values() if v}),
        first_restack_ms={st.scheduler.shard or "single": st.batch._resident.last_restack_ms
                          for st in stacks},
        restacks={st.scheduler.shard or "single": st.batch.restacks for st in stacks},
        commits=g.accountant.commit_commits, conflicts=g.accountant.commit_conflicts,
        rollbacks=g.metrics.shard_rollbacks.total(),
        journal_summary=(g.accountant.journal.summary()
                         if g.accountant.journal is not None else None),
        kernels=kept.errors() if platform != "cpu" else None,
        threads=sorted(kept.threads) if platform != "cpu" else [],
    )
    if prof is not None:
        out["overlap"] = lane_overlap(prof)
    if g.accountant.journal is not None:
        g.accountant.journal.close()
    for st in stacks:
        st.close()
    return out


def lane_overlap(prof) -> dict:
    """From a profiler window over (o2): the fleet_eval and joint_fit
    device records per stream, and how many of them overlap in time a
    record of either kernel on another stream (lanes launching side by
    side on the card)."""
    records = []
    for kernel in ("fleet_eval", "joint_fit"):
        for stream, ivs in stream_kernels(prof, kernel).items():
            records += [(stream, a, b) for a, b in ivs]
    records.sort(key=lambda r: r[1])
    overlapped = 0
    for i, (s, a, b) in enumerate(records):
        if any(s2 != s and a2 < b and a < b2 for s2, a2, b2 in records[max(0, i - 64): i + 64]):
            overlapped += 1
    streams: dict = {}
    for s, a, b in records:
        streams[s] = streams.get(s, 0) + 1
    return dict(records=len(records), streams=len(streams), per_stream=streams,
                overlapped=overlapped,
                device_ms=sum(b - a for _, a, b in records) / 1e6)


def run_lanes(platform: str, size: dict = LANES_FULL, *, reported: bool = True) -> dict:
    """Run (o): (o1), (o3) and (o4) on ``platform``; with ``reported`` also
    (o2) (card only: its numbers are the card's), as one stack and with the
    journal off too where ``size`` asks for them."""
    o1, o3 = run_lanes_stepped(platform, size)
    out = dict(o1=o1, o3=o3, o4=run_profiles(platform, size))
    if reported:
        out["o2"] = run_lanes_wall(platform, size, shards=size["shards"], journal=True,
                                   profiled=True)
        if size["single"]:
            out["o2_single"] = run_lanes_wall(platform, size, shards=1, journal=True)
        if size["nojournal"]:
            out["o2_nojournal"] = run_lanes_wall(platform, size, shards=size["shards"],
                                                 journal=False)
    return out


def check_lanes_run(run: dict, size: dict) -> None:
    """The gates every part of run (o) holds on its own."""
    o1, o3, o4 = run["o1"], run["o3"], run["o4"]
    for name, part in (("o1", o1), ("o3", o3), ("o4", o4)):
        if part["bound"] != part["pods"]:
            missing = [n for n, v in part["bindings"].items() if v is None][:8]
            raise AssertionError(f"({name}): {part['bound']}/{part['pods']} bound, "
                                 f"pending {missing}")
        for key in ("split", "overcommitted", "double_binds", "staged"):
            if part.get(key):
                raise AssertionError(f"({name}) {key}: {part[key]}")
    if o1["routes"].get("wide-000") != "global" or o1["lanes"].get("wide-000") != "global":
        raise AssertionError(f"(o1): the wide gang went to {o1['routes'].get('wide-000')}")
    if len(set(o1["lanes"].values())) != size["shards"] + 1:
        raise AssertionError(f"(o1): lanes that bound: {sorted(set(o1['lanes'].values()))}")
    if not o1["commits"] or not o1["journal"]:
        raise AssertionError("(o1): nothing committed or journaled")
    if not (o3["replayed"] and o3["warm"] and o3["residue"] and not o3["residue_left"]):
        raise AssertionError(
            f"(o3): replayed {o3['replayed']}, warm {o3['warm']}, residue "
            f"{len(o3['residue'])}, left after the drift pass {o3['residue_left']}")
    if o3["binds_at_resync"] != o3["binds_before_resync"]:
        raise AssertionError("(o3): a bind landed before the warm resync")
    if o3["replayed_gangs"].get(o3["parked_gang"]) != 2:
        raise AssertionError(f"(o3): replayed gangs {o3['replayed_gangs']}")
    if not o4["shared"] or len(set(o4["profiles"].values())) != 2:
        raise AssertionError(f"(o4): shared {o4['shared']}, profiles that bound "
                             f"{sorted(set(map(str, o4['profiles'].values())))}")


def check_lanes(g: dict, c: dict, size: dict) -> None:
    """Run (o) on the card against the same script on the CPU: (o1), (o3)
    and (o4) equal, journal files byte for byte; every card launch equal to
    its plain version; (o2)'s gates."""
    check_lanes_run(g, size)
    check_lanes_run(c, size)
    for part, keys in (("o1", O1_PARITY), ("o3", O3_PARITY), ("o4", O4_PARITY)):
        for key in keys:
            if g[part][key] != c[part][key]:
                a, b = g[part][key], c[part][key]
                diff = ([k for k in a if a[k] != b.get(k)][:8]
                        if isinstance(a, dict) else (str(a)[:200], str(b)[:200]))
                raise AssertionError(f"({part}) {key} differs from the CPU run: {diff}")
    for part in ("o1", "o3", "o4") + O2_PARTS:
        if part not in g:
            continue
        err = g[part]["kernels"]
        if any(err["max_abs_err"].values()) or err["kept"] != err["launches"]:
            raise AssertionError(f"({part}) kernels: {err}")
    for part in O2_PARTS:
        if part in g:
            check_lanes_wall(g[part], part)
    launched = {lane for lane, n in g["o2"]["lane_launches"].items() if n["fleet_eval"]}
    if len(launched) != size["shards"] + 1:
        raise AssertionError(f"(o2): lanes that launched fleet_eval {sorted(launched)}")


def check_lanes_wall(run: dict, part: str) -> None:
    """(o2)'s gates: every pod bound, gangs whole, no host over its chips,
    no pod bound twice, the accountant's claims exactly the bound pods,
    every thread ended."""
    for key in ("split", "overcommitted", "double_binds", "alive"):
        if run[key]:
            raise AssertionError(f"({part}) {key}: {run[key]}")
    if run["bound"] != run["pods"] or not run["claims_equal_bound"]:
        raise AssertionError(f"({part}): bound {run['bound']}/{run['pods']}, "
                             f"claims equal the bound pods {run['claims_equal_bound']}")


def print_lanes(run: dict, smi: str) -> None:
    drop = ("bindings", "lanes", "routes", "profiles", "journal", "gangs", "kernels")
    for part in ("o1", "o3", "o4") + O2_PARTS:
        if part in run:
            r = {k: v for k, v in run[part].items() if k not in drop}
            print(f"lanes run ({part}) {run[part]['platform']} [{smi}]:",
                  json.dumps(r, default=str))


def phase_lanes(smi: str, rerun: "SpawnedRerun") -> dict:
    g = run_lanes("auto")
    c = rerun.result()
    print_lanes(g, smi)
    print_lanes(c, smi)
    check_lanes(g, c, LANES_FULL)
    return g


# --- run (p): process lanes and the commit transport ------------------------

# Run (p) on run (o)'s 5,000-node fleet with the manifest's shard_count 4;
# the small size is what tests/test_torch_procserve.py runs on the CPU.
# (p1): run (b)'s singletons and run (c)'s plain gangs (the spec worker's
# host format carries generation and chips only, so v5p hosts come
# without slices and topology gangs have no block to take); ``warmup``
# singletons per worker before the timed round.
# ``baselines``: (p1)'s script also in one worker process and as thread
# lanes (reported); cut at the full size (PERF.md section 4): the
# comparison is recorded in PERF.md, and run (r) needed the time.
PROC_FULL = dict(slices=512, v5e_hosts=2952, shards=4, singles_b=256, plain=8,
                 plain_size=16, warmup=8, baselines=False)
PROC_SMALL = dict(slices=16, v5e_hosts=96, shards=2, singles_b=32, plain=2,
                  plain_size=4, warmup=2, baselines=True)
# (p2): the CLI over the wire with run (c)'s two gang waves and half of
# run (b)'s singletons (cut from 256 to hold the script's time); (p3):
# the leader / tailing standby pair with ``failover`` singletons, the
# leader stopped after half.
PROC_WIRE_FULL = dict(slices=512, v5e_hosts=2952, shards=4, singles_b=64, script={},
                      failover=64)
PROC_WIRE_SMALL = dict(slices=16, v5e_hosts=96, shards=2, singles_b=16,
                       script=dict(plain=2, plain_size=4, cosched=2, topo=2, multi=1,
                                   singles=8), failover=16)
PROC_RUN_DIR = "build/run_p"
P1_PARITY = ("lanes", "bindings", "claims", "reports", "conflicts")
# The fields of a spec worker's report that do not read a clock.
P1_REPORT_KEYS = ("lane", "pods", "commit_conflicts", "staged_residue", "binds",
                  "queue_depth", "staged")


def proc_dir(what: str):
    """A fresh directory under the checkout's build/ for one part of run
    (p) (journals, specs, worker results and logs); relative, so a Unix
    socket inside it stays well under the 107-byte path limit wherever the
    checkout lies."""
    import shutil
    from pathlib import Path

    d = Path(PROC_RUN_DIR) / f"{what}-{os.getpid()}"
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    return d


def journal_frames(d) -> "list[str]":
    """Every record payload of the journal in ``d``, segment by segment
    (each frame: length and CRC, then the payload)."""
    import struct

    hdr = struct.Struct("<II")
    out = []
    for p in sorted(d.glob("seg-*.log")):
        raw = p.read_bytes()
        i = 0
        while i + hdr.size <= len(raw):
            n, _crc = hdr.unpack_from(raw, i)
            out.append(raw[i + hdr.size: i + hdr.size + n].decode())
            i += hdr.size + n
    return out


def lane_records(frames: "list[str]") -> "tuple[dict, dict]":
    """The journal's claim records by the lane that staged them, in order,
    without the parent's sequence numbers (which interleave the lanes):
    ("S", pod, node, chips, gang), ("C", pods), ("R" | "B", pod); and each
    pod's committed node. A pod is its key (the worker's uid less its
    ``#n`` suffix)."""
    lane_of: dict = {}
    staged_at: dict = {}
    lanes: dict = {}
    bindings: dict = {}

    def key(uid: str) -> str:
        return uid.split("#", 1)[0]

    for payload in frames:
        f = payload.split("\x1f")
        kind = f[0]
        if kind == "S":
            uid, node, chips, shard, gang = f[2], f[3], int(f[4]), f[5], f[7]
            lane_of[uid], staged_at[uid] = shard, node
            lanes.setdefault(shard, []).append(("S", key(uid), node, chips, gang))
        elif kind == "C":
            uids = f[2].split(",")
            lanes.setdefault(lane_of.get(uids[0], ""), []).append(
                ("C", tuple(key(u) for u in uids)))
            for u in uids:
                bindings[key(u)] = staged_at.get(u)
        elif kind in ("R", "B"):
            lanes.setdefault(lane_of.get(f[2], ""), []).append((kind, key(f[2])))
    return lanes, bindings


def proc_spec_script(size: dict, router) -> "tuple[dict, dict, list]":
    """(p1)'s timed pods by lane, as the parent's router routes them (each
    pod with its own name as uid): run (b)'s singletons, then run (c)'s
    plain gangs; the gangs, name -> size; and the pods the router sent to
    the global lane (none are expected)."""
    from yoda_tpu_torch.api.types import PodSpec

    waves, gangs = gang_script(seed=1, plain=size["plain"], plain_size=size["plain_size"],
                               cosched=0, topo=0, multi=0, singles=0)
    pods = [(f"b{n}", dict(labels))
            for n, labels in fleet_and_pods(seed=0)[1][: size["singles_b"]]]
    pods += [(n, dict(labels)) for n, labels, _ in waves[0]]
    by_lane: dict = {}
    global_lane = []
    for name, labels in pods:
        lane = router.route(PodSpec(name, labels=labels, uid=f"default/{name}"))
        if lane == "global":
            global_lane.append(name)
        by_lane.setdefault(lane, []).append({"name": name, "labels": labels})
    return by_lane, {g: n for g, (_kind, n) in gangs.items()}, global_lane


def spec_worker_entry(argv: "list[str]") -> int:
    """``chip_smoke.py --spec-worker SPEC OUT DEVICE``: run (p1)'s worker
    process. It runs the port's own spec worker
    (``procserve._run_spec_worker``) with, on the card, every
    ``fleet_eval`` / ``joint_fit`` launch kept (:class:`KeptKernels`, the
    counts zeroed as it installs) and the evaluation round trip timed; at
    exit it writes the launches, the launches held against the plain
    versions with the largest difference, the dispatch chain's counters
    (:class:`DispatchWatch`) and ms per evaluation to OUT."""
    spec_path, out_path, device = argv
    from yoda_tpu_torch.framework import procserve
    from yoda_tpu_torch.ops.kernel import TorchFleetKernel

    with open(spec_path) as f:
        spec = json.load(f)
    eval_s: list = []
    real_eval = TorchFleetKernel.evaluate_burst

    def timed(self, *args, **kw):
        t = time.perf_counter()
        try:
            return real_eval(self, *args, **kw)
        finally:
            eval_s.append(time.perf_counter() - t)

    TorchFleetKernel.evaluate_burst = timed
    kept = KeptKernels() if device == "cuda" else None
    watch = DispatchWatch().install()
    out = dict(pid=os.getpid(), device=device, rc=None)
    try:
        if kept is not None:
            kept.install()
        try:
            out["rc"] = procserve._run_spec_worker(spec, device)
        finally:
            out["dispatch"] = dict(watch.counts)
            if kept is not None:
                kept.restore()
                out["kernels"] = kept.errors()
    except BaseException as e:  # noqa: BLE001 — written to OUT, then re-raised
        out["error"] = f"{type(e).__name__}: {e}"
        raise
    finally:
        out["eval_calls"] = len(eval_s)
        out["eval_ms_per_call"] = 1e3 * sum(eval_s) / len(eval_s) if eval_s else None
        with open(out_path, "w") as f:
            json.dump(out, f)
    return out["rc"]


def run_proc_spec(platform: str, size: dict, what: str = "p1") -> dict:
    """(p1): this process is the parent (``build_proc_parent``, the journal
    on, ``journal_sync: batch``) with a ``CommitRPCServer`` on a Unix
    socket and a ``WorkerSupervisor`` over ``shards`` spec workers, spawned
    through :func:`spec_worker_entry`; each worker gets the hosts of its
    ``ShardMap`` partition (generation and chips) and the pods the parent's
    router sends its lane, drains ``warmup`` singletons, waits at the start
    barrier and drains the timed pods. Returns each lane's journal
    records, the committed bindings, the parent's claims, the reports and
    the workers' own results."""
    from yoda_tpu_torch.cluster.fake import FakeCluster
    from yoda_tpu_torch.config import SchedulerConfig
    from yoda_tpu_torch.framework.procserve import CommitRPCServer
    from yoda_tpu_torch.framework.shards import ShardMap, WorkerSupervisor, shard_name
    from yoda_tpu_torch.standalone import build_proc_parent

    d = proc_dir(f"{what}-{platform}")
    n = size["shards"]
    cfg = SchedulerConfig(kernel_platform=platform, batch_requests=16, shard_count=n,
                          shard_mode="process", journal_path=str(d / "journal"),
                          journal_sync="batch")
    ss = build_proc_parent(FakeCluster(), cfg)
    cluster = ss.global_stack.cluster
    publish_fleet(cluster, size)
    smap = ShardMap(n)
    hosts: dict = {}
    capacity = {}
    for t in cluster.list_tpu_metrics():
        capacity[t.name] = len(t.healthy_chips())
        lane = next(i for i in range(n) if smap.node_filter(i)(t.name, t))
        hosts.setdefault(lane, []).append(
            {"name": t.name, "generation": t.generation, "chips": len(t.chips)})
    by_lane, gangs, global_lane = proc_spec_script(size, ss.router)
    warm = [(n_, dict(labels)) for n_, labels in fleet_and_pods(seed=3)[0][: size["warmup"]]]
    sock = str(d / "c.sock")
    server = CommitRPCServer(ss.accountant, sock, metrics=ss.metrics,
                             fence_fn=lambda: True, expected_workers=n)
    server.start()
    device = "cpu" if platform == "cpu" else "cuda"
    results, procs = {}, {}

    def spawn(i: int):
        lane = shard_name(i)
        spec = {"socket": sock, "shard_index": i, "workers": n, "barrier_timeout_s": 300.0,
                "config": {"batch_requests": 16}, "hosts": hosts.get(i, []),
                "warmup_pods": [{"name": f"warm-{lane}-{w}", "labels": labels}
                                for w, labels in warm],
                "pods": by_lane.get(lane, [])}
        (d / f"{lane}.json").write_text(json.dumps(spec))
        results[lane] = d / f"{lane}.out.json"
        # One string hash seed for every worker, whoever runs this: a
        # gang's Permit waiters are released in set order, and so are the
        # uids of the parent's commit records.
        with open(d / f"{lane}.log", "w") as log:
            procs[lane] = subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--spec-worker",
                 str(d / f"{lane}.json"), str(results[lane]), device],
                stdout=log, stderr=subprocess.STDOUT,
                env=dict(os.environ, PYTHONHASHSEED="0"))
        return procs[lane]

    sup = WorkerSupervisor(spawn, n, max_respawns=0)
    t0 = time.monotonic()
    try:
        sup.start()
        wait_for(lambda: sup.alive() == 0, 600, "every spec worker to exit", poll_s=0.1)
    finally:
        sup.stop()
        reports = dict(server.reports)
        server.stop()
    wall = time.monotonic() - t0
    rcs = {lane: p.returncode for lane, p in procs.items()}
    workers = {}
    for lane, path in results.items():
        workers[lane] = json.loads(path.read_text()) if path.exists() else {}
        if rcs.get(lane) != 0:
            tail = (d / f"{lane}.log").read_text()[-3000:]
            raise AssertionError(f"(p1) worker {lane} exited {rcs.get(lane)}:\n{tail}")
    rpc = {op: dict(calls=ss.metrics.commit_rpc_latency.count(op=op, transport="unix"),
                    p50_ms=ss.metrics.commit_rpc_latency.quantile(0.5, op=op, transport="unix"),
                    p99_ms=ss.metrics.commit_rpc_latency.quantile(0.99, op=op,
                                                                   transport="unix"))
           for op in ("stage", "commit", "release", "heartbeat")}
    staged, conflicts = ss.accountant.staged_count(), ss.accountant.commit_conflicts
    claims = ss.accountant.claims_snapshot()
    leaked = {h: c for h, c in ss.accountant.chips_by_node().items() if c}
    ss.accountant.journal.close()
    ss.close()
    lanes, bindings = lane_records(journal_frames(d / "journal"))
    timed = {lane: [p["name"] for p in pods] for lane, pods in by_lane.items()}
    used: dict = {}
    labels_of = {p["name"]: p["labels"] for pods in by_lane.values() for p in pods}
    for name in labels_of:
        node = bindings.get(f"default/{name}")
        if node is not None:
            used[node] = used.get(node, 0) + int(labels_of[name].get("tpu/chips", "1"))
    split = [g for g, size_g in gangs.items()
             if sum(1 for m in range(size_g) if f"default/{g}-{m:02d}" in bindings)
             not in (0, size_g)]
    slowest = max((r["wall_s"] for r in reports.values()), default=0.0)
    pods = sum(len(v) for v in timed.values())
    return dict(
        platform=platform, workers_n=n, pods=pods, wall_s=wall, cpu_count=os.cpu_count(),
        global_lane=global_lane, rcs=rcs,
        unbound=sorted(nm for nm in labels_of if f"default/{nm}" not in bindings),
        over=sorted(h for h, u in used.items() if u > capacity[h]), split=split,
        staged_residue=staged, leaked=leaked, conflicts=conflicts,
        lanes=lanes, bindings={nm: bindings.get(f"default/{nm}") for nm in sorted(labels_of)},
        claims=claims,
        reports={lane: {k: r.get(k) for k in P1_REPORT_KEYS} for lane, r in reports.items()},
        timing={lane: dict(pods_per_s=r.get("pods_per_s"), wall_s=r.get("wall_s"),
                           admission_p99_s=r.get("admission_p99_s"), pid=r.get("pid"),
                           eval_ms_per_call=workers[lane].get("eval_ms_per_call"),
                           eval_calls=workers[lane].get("eval_calls"))
                for lane, r in reports.items()},
        pods_per_s=pods / slowest if slowest else 0.0,
        commit_rpc=rpc,
        kernels={lane: w.get("kernels") for lane, w in workers.items()},
        dispatch={lane: w.get("dispatch") for lane, w in workers.items()},
    )


def run_proc_threads(platform: str, size: dict) -> dict:
    """(p1)'s script hosted as thread lanes: ``build_sharded_stacks`` with
    ``shards`` lanes in this process over the hosts as the spec workers
    see them (generation and chips, no slices), the pods as its own router
    routes them; 8 warm-up singletons a lane drained and deleted, then the
    timed pods drained by ``ShardSet.run_until_idle`` (every lane on a
    thread of its own). Reported beside (p1): the interpreter lock's share
    of the thread lanes' cost (Q17)."""
    from yoda_tpu_torch.agent.fake_publisher import FakeTpuAgent
    from yoda_tpu_torch.api.types import PodSpec
    from yoda_tpu_torch.cluster.fake import FakeCluster
    from yoda_tpu_torch.config import SchedulerConfig
    from yoda_tpu_torch.standalone import build_sharded_stacks

    cfg = SchedulerConfig(kernel_platform=platform, batch_requests=16,
                          shard_count=size["shards"])
    ss = build_sharded_stacks(FakeCluster(), cfg)
    cluster = ss.global_stack.cluster
    scratch = FakeCluster()
    publish_fleet(scratch, size)
    agent = FakeTpuAgent(cluster)
    for t in scratch.list_tpu_metrics():
        agent.add_host(t.name, generation=t.generation, chips=len(t.chips))
    agent.publish_all()
    by_lane, _gangs, _global = proc_spec_script(size, ss.router)
    warm = [(f"warm-{i}-{n}", dict(labels)) for i in range(size["shards"])
            for n, labels in fleet_and_pods(seed=3)[0][: size["warmup"]]]
    for name, labels in warm:
        cluster.create_pod(PodSpec(name, labels=labels, uid=f"default/{name}"))
    ss.run_until_idle(max_wall_s=600)
    for name, _ in warm:
        cluster.delete_pod(f"default/{name}")
    ss.run_until_idle(max_wall_s=60)
    pods = [p for lane in by_lane.values() for p in lane]
    for p in pods:
        cluster.create_pod(PodSpec(p["name"], labels=p["labels"], uid=f"default/{p['name']}"))
    t0 = time.monotonic()
    ss.run_until_idle(max_wall_s=600)
    wall = time.monotonic() - t0
    bound = sum(1 for p in pods if cluster.get_pod(f"default/{p['name']}").node_name)
    ss.close()
    return dict(pods=len(pods), bound=bound, wall_s=wall,
                pods_per_s=len(pods) / wall if wall else 0.0,
                lanes={lane: len(v) for lane, v in by_lane.items()})


def check_proc_spec_run(run: dict, size: dict) -> None:
    """(p1)'s gates on one platform: every worker exited 0 and reported;
    every pod bound and committed, gangs whole, no host over its chips;
    no pod routed to the global lane (nothing serves it here); 0 staged
    residue, 0 leaked chips and 0 commit conflicts at the parent; no
    worker's dispatch caught an error or demoted."""
    n = size["shards"]
    if sorted(run["reports"]) != [f"s{i}" for i in range(n)]:
        raise AssertionError(f"(p1) reports from {sorted(run['reports'])}")
    for key in ("global_lane", "unbound", "over", "split", "leaked"):
        if run[key]:
            raise AssertionError(f"(p1) {key}: {str(run[key])[:300]}")
    if run["staged_residue"] or run["conflicts"]:
        raise AssertionError(f"(p1) staged residue {run['staged_residue']}, "
                             f"conflicts {run['conflicts']}")
    for lane, r in run["reports"].items():
        if r["staged_residue"] or r["commit_conflicts"]:
            raise AssertionError(f"(p1) {lane} report: {r}")
    for lane, d in run["dispatch"].items():
        if d is None or demoted(d):
            raise AssertionError(f"(p1) worker {lane} dispatch chain: {d}")
    if sum(r["pods"] for r in run["reports"].values()) != run["pods"]:
        raise AssertionError(f"(p1) reported pods {run['reports']} of {run['pods']}")


def check_proc_spec(g: dict, c: dict, size: dict) -> None:
    """(p1) on the card against its CPU run: both pass their gates; lanes'
    journal records, bindings, the parent's claims, the reports and the
    conflicts equal; every worker launched ``fleet_eval``, and every launch
    equals its plain version."""
    check_proc_spec_run(g, size)
    check_proc_spec_run(c, size)
    for key in P1_PARITY:
        if g[key] != c[key]:
            a, b = g[key], c[key]
            diff = ([k for k in a if a[k] != b.get(k)][:8] if isinstance(a, dict)
                    else (str(a)[:200], str(b)[:200]))
            raise AssertionError(f"(p1) {key} differs from the CPU run: {diff}")
    for lane, err in g["kernels"].items():
        if err is None or not err["launches"]["fleet_eval"]:
            raise AssertionError(f"(p1) worker {lane} launched no fleet_eval: {err}")
        if any(err["max_abs_err"].values()) or err["kept"] != err["launches"]:
            raise AssertionError(f"(p1) worker {lane} kernels: {err}")


def smi_compute_apps() -> "list[tuple[int, str]]":
    """The processes nvidia-smi sees on the card: (pid, used memory) per
    CUDA context."""
    out = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid,used_memory", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout
    apps = []
    for line in out.strip().splitlines():
        pid, _, mem = line.partition(",")
        if pid.strip().isdigit():
            apps.append((int(pid), mem.strip()))
    return apps


def on_card(pid: int, apps: "list[tuple[int, str]]") -> dict:
    """The evidence that process ``pid`` runs on the card: nvidia-smi lists
    its pid among the compute apps (where nvidia-smi reports this pid
    namespace's pids), it holds the card's device files open, and it has
    the CUDA driver and the fleet_eval kernel library mapped."""
    try:
        fds = [os.readlink(f"/proc/{pid}/fd/{fd}") for fd in os.listdir(f"/proc/{pid}/fd")]
        with open(f"/proc/{pid}/maps") as f:
            maps = f.read()
    except OSError:
        fds, maps = [], ""
    return dict(in_smi=pid in {p for p, _ in apps},
                nvidia_fds=sum(1 for x in fds if x.startswith("/dev/nvidia")),
                libcuda="libcuda.so" in maps, fleet_eval_lib="libfleet_eval-" in maps)


def smi_compute_mode() -> dict:
    """The card's compute mode, and whether an MPS server runs."""
    mode = subprocess.run(
        ["nvidia-smi", "--query-gpu=compute_mode", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    names = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=process_name", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout
    return dict(compute_mode=mode, mps="nvidia-cuda-mps-server" in names
                or bool(os.environ.get("CUDA_MPS_PIPE_DIRECTORY")))


class ParentCapture:
    """While entered, ``standalone.build_proc_parent`` — which the CLI
    reaches through the module attribute — records each parent it builds
    (by the building thread's name): the shard set whose ``supervisor``
    the CLI attaches."""

    def __enter__(self):
        from yoda_tpu_torch import standalone

        self.mod, self.real, self.sets = standalone, standalone.build_proc_parent, {}

        def build_proc_parent(*args, **kw):
            ss = self.real(*args, **kw)
            self.sets[threading.current_thread().name] = ss
            return ss

        standalone.build_proc_parent = build_proc_parent
        return self

    def __exit__(self, *exc):
        self.mod.build_proc_parent = self.real
        return False


def write_config(d, name: str, **knobs) -> str:
    lines = [f"{k}: {json.dumps(v)}" for k, v in knobs.items()]
    path = d / f"{name}.yaml"
    path.write_text("\n".join(lines) + "\n")
    return str(path)


def shards_view(port: int) -> dict:
    status, text = http_get(f"http://127.0.0.1:{port}/debug/shards")
    return json.loads(text) if status == 200 else {}


def partition_of(slice_of: dict, n: int) -> "dict[str, int]":
    """Each host's lane under ``ShardMap(n)`` (its slice, else itself, is
    the pool)."""
    from yoda_tpu_torch.framework.shards import ShardMap

    smap = ShardMap(n)
    return {h: smap.shard_of_pool(s or f"host:{h}") for h, s in slice_of.items()}


def run_proc_wire(platform: str, size: dict = PROC_WIRE_FULL) -> dict:
    """(p2): ``python -m yoda_tpu_torch.cli`` with ``shard_count`` 4,
    ``shard_mode: process`` and the journal, over the port's fake API
    server in its own process (run (l)'s harness) holding the fleet with
    its slices; run (c)'s two gang waves with ``singles_b`` of run (b)'s
    singletons split over them, over HTTP; the worker of lane s0 gets
    SIGKILL once half of wave 1 is bound, and the supervisor respawns it."""
    from collections import Counter

    from yoda_tpu_torch.api.requests import gang_name_of

    d = proc_dir(f"p2-{platform}")
    n = size["shards"]
    waves, gangs = gang_script(seed=1, **size["script"])
    singles = fleet_and_pods(seed=0)[1][: size["singles_b"]]
    half = len(singles) // 2
    waves = [[(nm, dict(lab)) for nm, lab, _ in waves[0]]
             + [(f"b{nm}", dict(lab)) for nm, lab in singles[:half]],
             [(nm, dict(lab)) for nm, lab, _ in waves[1]]
             + [(f"b{nm}", dict(lab)) for nm, lab in singles[half:]]]
    labels_of = {f"default/{nm}": lab for w in waves for nm, lab in w}
    config = write_config(d, "p2", shard_count=n, shard_mode="process",
                          journal_path=str(d / "journal"), journal_sync="batch",
                          batch_requests=16, gang_permit_timeout_s=O2_PERMIT_TIMEOUT_S,
                          reconcile_period_s=5.0)
    port = free_port()
    argv = ["--config", config, "--metrics-port", str(port)] + (
        ["--device", "cpu"] if platform == "cpu" else [])
    apps_before, apps_after, cuda_before, cuda_after = [], [], {}, {}
    self_in_smi = None
    with ApiServerProcess(size) as server:
        part = partition_of(server.slice_of, n)
        client = seed_client(server)
        with ParentCapture() as parents, Replicas(server.base_url) as reps:
            t_start = time.monotonic()
            reps.start("p2", argv)
            wait_for(lambda: http_get(f"http://127.0.0.1:{port}/readyz")[0] == 200,
                     300, "/readyz 200")
            wait_for(lambda: sum(1 for r in shards_view(port).get("workers", [])
                                 if r.get("heartbeat_age_s") is not None) == n,
                     300, "every worker's heartbeat", poll_s=0.2)
            t_ready = time.monotonic()
            ss = parents.sets["p2"]
            pids_before = {r["lane"]: r["pid"] for r in shards_view(port)["workers"]}
            created = create_pods(client, waves[0])
            keys0 = [f"default/{nm}" for nm, _ in waves[0]]
            wait_for(lambda: sum(v is not None for v in server.bound(keys0).values())
                     >= len(keys0) // 2, 300, "half of wave 1 bound", poll_s=0.05)
            # Every worker has run a cycle (a worker makes its CUDA context
            # and loads the kernel library at its first evaluation).
            wait_for(lambda: all(r.get("cycles") for r in shards_view(port)["workers"]),
                     120, "a cycle on every worker", poll_s=0.05)
            if platform != "cpu":
                apps_before = smi_compute_apps()
                cuda_before = {lane: on_card(pid, apps_before)
                               for lane, pid in pids_before.items()}
            t_kill = time.monotonic()
            ss.supervisor.kill(0)
            wait_for(lambda: all(v is not None for v in server.bound(keys0).values()),
                     300, "wave 1 bound", poll_s=0.05)
            created.update(create_pods(client, waves[1]))
            try:
                wait_for(lambda: all(v is not None for v in server.bound(labels_of).values()),
                         300, "every pod bound", poll_s=0.05)
            except AssertionError as e:
                left = sorted(k for k, v in server.bound(labels_of).items() if v is None)
                raise AssertionError(f"{e}: {len(left)} left {left[:12]}, workers "
                                     f"{shards_view(port).get('workers')}, staged "
                                     f"{ss.accountant.staged_uids()}") from None
            t_done = time.monotonic()

            def respawned() -> bool:
                rows = {r["lane"]: r for r in shards_view(port).get("workers", [])}
                s0 = rows.get("s0", {})
                return (len([r for r in rows.values() if r.get("alive")]) == n
                        and s0.get("restarts") == 1 and s0.get("pid") != pids_before["s0"]
                        and s0.get("heartbeat_age_s") is not None)

            wait_for(respawned, 120, "the killed worker respawned", poll_s=0.2)
            if platform != "cpu":
                apps_after = smi_compute_apps()
                cuda_after = {r["lane"]: on_card(r["pid"], apps_after)
                              for r in shards_view(port)["workers"]}
                self_in_smi = os.getpid() in {p for p, _ in apps_after}
            # The drift pass (every reconcile_period_s) finalizes the
            # killed worker's bound residue.
            wait_for(lambda: ss.accountant.staged_count() == 0, 60,
                     "no staged residue after the drift pass", poll_s=0.2)
            view = shards_view(port)
            values = scrape(port)
            reps.stop("p2", timeout_s=120)
            rc = reps.rc.get("p2")
        bound = server.bound(labels_of)
        log = server.bindings()
    posts, bound_at, conflicts = binding_counts(log)
    checks = wire_checks(bound, labels_of, gangs, server.capacity, server.slice_of, posts)
    # A multislice gang's valid block: a member on each of 8 hosts, four
    # on each of two slices.
    checks["misplaced_multislice"] = sorted(
        g for g, (kind, _n) in gangs.items() if kind == "multislice" and sorted(
            Counter(server.slice_of[node] for k, node in bound.items()
                    if node and k.startswith(f"default/{g}-")).values()) != [4, 4])
    rebinds = sorted(k for k, c in posts.items() if c > 1)
    checks.pop("double_posts")
    lat = sorted(bound_at[k] - created[k] for k in labels_of if k in bound_at)
    after_kill = [(m, node) for key, node, status, m, _w in log
                  if status == 201 and m > t_kill and part.get(node) == 0]
    spans: dict = {}
    for k in labels_of:
        g = gang_name_of(labels_of[k])
        if g is not None and k in bound_at:
            lo, hi = spans.get(g, (float("inf"), 0.0))
            spans[g] = (min(lo, created[k]), max(hi, bound_at[k]))
    completion = sorted(hi - lo for lo, hi in spans.values())
    t_first = min(created.values())
    rpc_calls = sum(v for k, v in values.items() if k.startswith("yoda_commit_rpc_calls_total"))
    return dict(
        platform=platform, pods=len(labels_of), rc=rc, checks=checks, conflicts=conflicts,
        rebinds=len(rebinds), bound=sum(v is not None for v in bound.values()),
        start_to_workers_s=t_ready - t_start,
        workers=view.get("workers", []), pids_before=pids_before,
        on_card_before=cuda_before, on_card_after=cuda_after,
        smi_apps_before=apps_before, smi_apps_after=apps_after,
        parent_pid=os.getpid(), parent_in_smi=self_in_smi,
        kill_to_respawned_first_bind_ms=(1e3 * (min(m for m, _ in after_kill) - t_kill)
                                         if after_kill else None),
        pods_per_s=len(lat) / (t_done - t_first) if lat else 0.0,
        p50_ms=pct_ms(lat, 0.5), p99_ms=pct_ms(lat, 0.99),
        gang_p50_ms=pct_ms(completion, 0.5), gang_p99_ms=pct_ms(completion, 0.99),
        commit_rpc_calls=rpc_calls,
        commit_rpc_conflicts=sum(v for k, v in values.items()
                                 if k.startswith("yoda_commit_rpc_conflicts_total")),
    )


def check_proc_wire(run: dict, size: dict, card: bool) -> None:
    """(p2)'s gates: the CLI exited 0; every pod bound, gangs whole on a
    valid block (a topology gang on four hosts of one slice, a multislice
    gang four members on each of two slices), no host over its chips, no binding POST refused as a
    second bind (409); four workers alive and lane s0 restarted once
    (``/debug/shards``); the commit RPC carried calls; on the card every
    worker, before the kill and after the respawn, running on the card:
    among nvidia-smi's compute apps where nvidia-smi reports this pid
    namespace (it lists the parent's own pid), and in any case holding
    the card's device files open with the CUDA driver and the fleet_eval
    library mapped, with nvidia-smi counting a context for each."""
    if run["rc"] != 0:
        raise AssertionError(f"(p2) the CLI returned {run['rc']}")
    for key, bad in run["checks"].items():
        if bad:
            raise AssertionError(f"(p2) {key}: {bad[:8]}")
    if run["conflicts"] or run["bound"] != run["pods"]:
        raise AssertionError(f"(p2) bound {run['bound']}/{run['pods']}, "
                             f"409s {run['conflicts']}")
    rows = {r["lane"]: r for r in run["workers"]}
    if (sorted(rows) != [f"s{i}" for i in range(size["shards"])]
            or not all(r.get("alive") for r in rows.values())
            or rows["s0"].get("restarts") != 1):
        raise AssertionError(f"(p2) /debug/shards: {run['workers']}")
    if not run["commit_rpc_calls"]:
        raise AssertionError("(p2) yoda_commit_rpc_calls_total is 0")
    if not card:
        return
    for when in ("before", "after"):
        rows = run[f"on_card_{when}"]
        bad = {lane: r for lane, r in rows.items()
               if not (r["nvidia_fds"] and r["libcuda"] and r["fleet_eval_lib"])
               or (run["parent_in_smi"] and not r["in_smi"])}
        # The parent and every worker each hold a context.
        if len(rows) != size["shards"] or bad or (
                len(run[f"smi_apps_{when}"]) < size["shards"] + 1):
            raise AssertionError(f"(p2) workers not on the card {when} the kill: {rows}, "
                                 f"nvidia-smi {run[f'smi_apps_{when}']}")


def run_proc_standby(platform: str, size: dict = PROC_WIRE_FULL) -> dict:
    """(p3): a ``--leader-elect`` leader CLI with ``shard_count`` 2,
    ``shard_mode: process`` and ``commit_listen`` on a free loopback port,
    and a ``--leader-elect`` standby with ``commit_endpoint`` pointing at
    it (its own journal, its own two workers, fenced), in one process;
    the leader binds the first half of ``failover`` singletons, the
    standby's tail reaches zero lag, the leader is stopped and the rest
    created: the standby promotes its tailed mirror, bumps the term and
    binds the rest."""
    d = proc_dir(f"p3-{platform}")
    singles = fleet_and_pods(23)[1][: size["failover"]]
    half = len(singles) // 2
    first = [(f"a-{nm}", lab) for nm, lab in singles[:half]]
    second = [(f"b-{nm}", lab) for nm, lab in singles[half:]]
    labels_of = {f"default/{nm}": lab for nm, lab in first + second}
    listen = f"127.0.0.1:{free_port()}"
    common = dict(shard_count=2, shard_mode="process", journal_sync="batch")
    configs = {
        "a": write_config(d, "leader", journal_path=str(d / "journal-a"),
                          commit_listen=listen, **common),
        "b": write_config(d, "standby", journal_path=str(d / "journal-b"),
                          commit_endpoint=listen, **common),
    }
    ports = {"a": free_port(), "b": free_port()}
    dev = ["--device", "cpu"] if platform == "cpu" else []

    def lag() -> "float | None":
        return scrape(ports["b"]).get("yoda_standby_lag_frames")

    with ApiServerProcess(size) as server:
        client = seed_client(server)
        with ParentCapture() as parents, Replicas(server.base_url) as reps:
            for r in ("a", "b"):
                reps.start(r, ["--leader-elect", "--lease-identity", f"replica-{r}",
                               "--metrics-port", str(ports[r]), "--config", configs[r]]
                           + dev)
                if r == "a":
                    wait_for(lambda: http_get(f"http://127.0.0.1:{ports['a']}/readyz")[0]
                             == 200, 300, "the leader ready")
            wait_for(lambda: http_get(f"http://127.0.0.1:{ports['b']}/healthz")[0] == 200,
                     300, "the standby up")
            create_pods(client, first)
            wait_for(lambda: all(v is not None for v in
                                 server.bound([f"default/{nm}" for nm, _ in first]).values()),
                     300, "the leader bound the first half", poll_s=0.05)
            leader = parents.sets["a"]
            wait_for(lambda: leader.accountant.staged_count() == 0, 60, "commits settled")
            leader_claims = leader.accountant.claims_snapshot()
            leader_journal = leader.accountant.journal.summary()
            wait_for(lambda: lag() == 0.0, 60, "the standby's tail at zero lag", poll_s=0.1)
            lag_before_stop = lag()
            standby = parents.sets["b"]
            # The standby's own journal head before the promotion (the
            # bound pods its watch layered on); the promotion continues the
            # shipped tail past it and the leader's.
            before = max(standby.accountant.journal.summary()["tail_seq"],
                         leader_journal["tail_seq"])
            t_stop = time.monotonic()
            reps.stops["a"].set()
            created = create_pods(client, second)
            reps.stop("a", timeout_s=120)
            wait_for(lambda: all(v is not None for v in server.bound(labels_of).values()),
                     300, "the standby bound the rest", poll_s=0.05)
            promoted_claims = {u: c for u, c in standby.accountant.claims_snapshot().items()
                               if u in leader_claims}
            summary = standby.accountant.journal.summary()
            # The standby's frames since the promotion: the first is its
            # term bump (a deferred snapshot later rotates the segment
            # that holds it away, so it is read from the ship ring).
            shipped = standby.accountant.journal.frames_since(before)
            values = scrape(ports["b"])
            reps.stop("b", timeout_s=120)
            rc = dict(reps.rc)
        bound = server.bound(labels_of)
        log = server.bindings()
    first_frame = shipped[0][0].split("\x1f") if shipped and shipped[0] else []
    posts, bound_at, conflicts = binding_counts(log)
    checks = wire_checks(bound, labels_of, {}, server.capacity, server.slice_of, posts)
    second_keys = [f"default/{nm}" for nm, _ in second]
    return dict(
        platform=platform, pods=len(labels_of), rc=rc, checks=checks, conflicts=conflicts,
        bound=sum(v is not None for v in bound.values()),
        lag_before_stop=lag_before_stop, leader_claims=len(leader_claims),
        leader_journal_term=leader_journal["term"],
        seq_before_promotion=before,
        warm=promoted_claims == leader_claims,
        standby_term=summary["term"], first_new_frame=first_frame,
        standby_lag_after=values.get("yoda_standby_lag_frames"),
        stop_to_standby_first_bind_ms=1e3 * (min(bound_at[k] for k in second_keys) - t_stop),
        second_half_p50_ms=pct_ms(sorted(bound_at[k] - created[k] for k in second_keys), 0.5),
    )


def check_proc_standby(run: dict) -> None:
    """(p3)'s gates: both CLIs returned 0; the standby's lag read 0 before
    the stop; it promoted warm (the leader's claims adopted) at the old
    term + 1, with the term bump as its journal's first frame; every pod
    bound once on a host with room."""
    if set(run["rc"].values()) != {0}:
        raise AssertionError(f"(p3) the CLIs returned {run['rc']}")
    if run["lag_before_stop"] != 0.0:
        raise AssertionError(f"(p3) standby lag before the stop {run['lag_before_stop']}")
    if not run["warm"] or not run["leader_claims"]:
        raise AssertionError(f"(p3) not promoted warm ({run['leader_claims']} claims)")
    old = max(1, run["leader_journal_term"])
    first = run["first_new_frame"]
    if (run["standby_term"] != old + 1 or len(first) != 3 or first[0] != "T"
            or first[2] != str(old + 1) or int(first[1]) <= run["seq_before_promotion"]):
        raise AssertionError(f"(p3) term {run['standby_term']}, first new frame {first} "
                             f"(old term {old}, seq before {run['seq_before_promotion']})")
    for key, bad in run["checks"].items():
        if bad:
            raise AssertionError(f"(p3) {key}: {bad[:8]}")
    if run["conflicts"] or run["bound"] != run["pods"]:
        raise AssertionError(f"(p3) bound {run['bound']}/{run['pods']}, "
                             f"409s {run['conflicts']}")


def run_proc(platform: str, size: dict = PROC_FULL, *, reported: bool = True) -> dict:
    """Run (p): (p1) on ``platform``; with ``reported`` also (p2) and
    (p3) (their numbers are the card's)."""
    out = dict(p1=run_proc_spec(platform, size))
    if reported:
        wire = PROC_WIRE_FULL if size is PROC_FULL else PROC_WIRE_SMALL
        out["p2"] = run_proc_wire(platform, wire)
        out["p3"] = run_proc_standby(platform, wire)
    return out


def print_proc(run: dict, smi: str) -> None:
    drop = ("lanes", "bindings", "claims", "reports", "kernels")
    for part in ("p1", "p1_single", "p2", "p3"):
        if part in run:
            r = {k: v for k, v in run[part].items() if k not in drop}
            print(f"process lanes run ({part}) {run[part]['platform']} [{smi}]:",
                  json.dumps(r, default=str))


def phase_proc(smi: str, lanes: dict) -> dict:
    """Run (p) on the card: (p1), (p1)'s script as one worker process and
    as thread lanes beside it (reported; where ``PROC_FULL`` asks for
    them), (p1)'s CPU run (spawned only
    then: its five processes beside the earlier phases slowed the host
    that those phases time), then (p2) and (p3)."""
    print("process lanes run (p): card", json.dumps(smi_compute_mode()))
    seconds = {}
    t = time.monotonic()
    p1 = run_proc_spec("auto", PROC_FULL)
    seconds["p1"] = time.monotonic() - t
    print_proc(dict(p1=p1), smi)
    out = dict(p1=p1)
    if PROC_FULL["baselines"]:
        t = time.monotonic()
        single = run_proc_spec("auto", dict(PROC_FULL, shards=1), "p1-single")
        check_proc_spec_run(single, dict(PROC_FULL, shards=1))
        threads = run_proc_threads("auto", PROC_FULL)
        if threads["bound"] != threads["pods"]:
            raise AssertionError(
                f"(p1) thread lanes bound {threads['bound']}/{threads['pods']}")
        seconds["p1_baselines"] = time.monotonic() - t
        out.update(p1_single=single, p1_threads=threads)
        print_proc(dict(p1_single=single), smi)
        print(f"process lanes run (p1) [{smi}]: {p1['pods_per_s']:.1f} pods/s over "
              f"{p1['workers_n']} worker processes, {single['pods_per_s']:.1f} in one worker "
              f"process, {threads['pods_per_s']:.1f} over {PROC_FULL['shards']} thread lanes "
              f"and the global lane ({threads['pods']} pods, {threads['wall_s']:.3f} s)")
    t = time.monotonic()
    rerun = SpawnedRerun("run_proc", PROC_FULL, "run (p1)")
    try:
        c = rerun.result()
    finally:
        rerun.stop()
    seconds["p1_cpu"] = time.monotonic() - t
    print_proc(c, smi)
    check_proc_spec(p1, c["p1"], PROC_FULL)
    t = time.monotonic()
    out["p2"] = run_proc_wire("auto", PROC_WIRE_FULL)
    seconds["p2"] = time.monotonic() - t
    print_proc(dict(p2=out["p2"]), smi)
    check_proc_wire(out["p2"], PROC_WIRE_FULL, card=True)
    t = time.monotonic()
    out["p3"] = run_proc_standby("auto", PROC_WIRE_FULL)
    seconds["p3"] = time.monotonic() - t
    print_proc(dict(p3=out["p3"]), smi)
    check_proc_standby(out["p3"])
    print("process lanes run (p) seconds:", json.dumps(seconds))
    print(f"process lanes run (p1): {p1['pods_per_s']:.1f} pods/s over {p1['workers_n']} "
          f"worker processes against run (o2)'s four thread lanes "
          f"{lanes['o2']['pods_per_s']:.1f} (run (o)'s script); os.cpu_count() "
          f"{p1['cpu_count']}")
    return out


# --- run (q): the trace replayer and the chaos harness ----------------------

# ``rate`` scales every arrival rate of run (q1)'s trace; ``kill`` and
# ``drain`` are its failure burst's and rolling drain's host counts.
CHAOS_FULL = dict(hosts=2952, slices=512, rate=1.0, kill=4, drain=8, shards=4, contended=4,
                  contention_hosts=2952)
CHAOS_SMALL = dict(hosts=64, slices=8, rate=0.25, kill=2, drain=4, shards=4, contended=4,
                   contention_hosts=8)
REPLAY_SEED = 16
CRASH_SEED = 11
STORM_SEED = 1337
STORM_ROUNDS = 8
REPLAY_COUNTS = ("lifecycles", "scheduled_created", "foreign_created", "deleted", "binds",
                 "preemptions", "repairs", "ingest_events", "ingest_batches", "shed",
                 "overload_peak_level", "killed_nodes", "drained_nodes", "drain_leftover")


def port_testing() -> dict:
    """The modules run (q) drives: the port's (the tests pass the JAX
    package's under the same keys)."""
    import yoda_tpu_torch.api.types as types
    import yoda_tpu_torch.config as config
    import yoda_tpu_torch.overload as overload
    import yoda_tpu_torch.standalone as standalone
    from yoda_tpu_torch.testing import chaos, tracegen

    return {"tracegen": tracegen, "chaos": chaos, "standalone": standalone,
            "config": config, "types": types, "overload": overload}


class StackTap:
    """While entered, every stack ``standalone.build_stack`` builds (alone,
    or inside ``build_sharded_stacks``, which reaches it through the module
    attribute) evaluates on ``platform`` where its configuration leaves
    "auto" ("auto" itself is the card), runs on ``clock`` where its
    builder left the wall clock (when a clock is given), is kept in
    ``stacks``, and logs every bind through its cluster front in
    ``binds`` (pod key -> the nodes it was bound to, in order)."""

    def __init__(self, m: dict, platform: str, clock=None) -> None:
        self.m, self.platform, self.clock = m, platform, clock
        self.stacks: list = []
        self.binds: dict = {}
        self._fronts: set = set()

    def __enter__(self):
        standalone = self.m["standalone"]
        real = self.real = standalone.build_stack

        def build_stack(cluster=None, config=None, **kw):
            config = config or self.m["config"].SchedulerConfig()
            if config.kernel_platform == "auto" and self.platform != "auto":
                config = dataclasses.replace(config, kernel_platform=self.platform)
            if self.clock is not None and kw.get("clock", time.monotonic) is time.monotonic:
                kw["clock"] = self.clock
            stack = real(cluster, config, **kw)
            self.stacks.append(stack)
            self._log_binds(stack.cluster)
            return stack

        standalone.build_stack = build_stack
        return self

    def __exit__(self, *exc):
        self.m["standalone"].build_stack = self.real
        return False

    def _log_binds(self, front) -> None:
        if id(front) in self._fronts:
            return
        self._fronts.add(id(front))
        real_bind = front.bind_pod

        def bind_pod(key, node):
            out = real_bind(key, node)
            self.binds.setdefault(key, []).append(node)
            return out

        front.bind_pod = bind_pod

    def devices(self) -> list:
        """Where each kept stack's batch plugin evaluates (the port's
        stacks; a stack without one says so)."""
        return sorted({str(getattr(getattr(st, "batch", None), "device", "none"))
                       for st in self.stacks})


def replay_spec(tg, size: dict):
    """Run (q1)'s trace: two minutes of three tenants' arrivals on a
    diurnal wave, a flash crowd, foreign churn, a failure burst and a
    rolling drain (``size`` scales the rates and the host counts)."""
    rate = size["rate"]
    return tg.TraceSpec(
        seed=REPLAY_SEED, duration_s=120.0, base_rate_per_s=6.0 * rate,
        diurnal_amplitude=0.4, diurnal_period_s=120.0, foreign_rate_per_s=20.0 * rate,
        tenants=(
            tg.TenantMix("team-a", priority=5, chips=(1, 2, 4)),
            tg.TenantMix("team-b", gang_fraction=0.3, gang_sizes=(2, 4), chips=(4, 8)),
            tg.TenantMix("team-c", weight=0.5, chips=(4,), gang_fraction=1.0,
                         gang_sizes=(4,), topology="2x2x1"),
        ),
        flash_crowds=(tg.FlashCrowd(30.0, 20.0, 15.0 * rate, "team-a"),),
        failure_bursts=((60.0, size["kill"]),),
        drains=((80.0, size["drain"]),),
        drain_recover_s=30.0,
    )


def run_replay(platform: str, size: dict, m: dict) -> dict:
    """(q1): ``testing.tracegen.replay`` of :func:`replay_spec` over
    ``size``'s fleet with the rebalancer driven, its stack built by the
    replay itself on its default configuration (``kernel_platform: auto``,
    the card) with ``bind_workers: 0``: the node health monitor and the
    rebalancer fan their unbinds out on the bind workers, and the order in
    which those land would decide the requeue order."""
    tg = m["tracegen"]
    config = dataclasses.replace(tg._default_config(), bind_workers=0)
    with StackTap(m, platform) as tap:
        report = tg.replay(replay_spec(tg, size), config=config, hosts=size["hosts"],
                           slices=size["slices"], drive_rebalancer=True, max_wall_s=900.0)
    return {
        "fingerprint": report.fingerprint(),
        "counts": {k: getattr(report, k) for k in REPLAY_COUNTS},
        "slo": report.slo,
        "verdict": [f"{a['sli']}:{a['tenant']}" for a in report.slo.get("alerts", [])] or "ok",
        "binds": tap.binds,
        "wall_s": report.wall_s,
        "pods_per_s": report.binds / report.wall_s if report.wall_s else None,
        "devices": tap.devices(),
    }


def contention_invariants(shard_set) -> list:
    """``tests/test_chaos.py``'s ``TestCrossShardContention._invariants``:
    no host over its healthy chips, no gang split, no claim of a pod that
    is gone; the violations found."""
    bad = []
    acct = shard_set.accountant
    cluster = shard_set.global_stack.cluster
    for ni in shard_set.global_stack.informer.snapshot().infos():
        used, cap = acct.chips_in_use(ni.name), len(ni.tpu.healthy_chips())
        if used > cap:
            bad.append(f"node {ni.name} oversubscribed {used} > {cap}")
    per_gang: dict = {}
    for p in cluster.list_pods():
        g = p.labels.get("tpu/gang")
        if g and p.node_name:
            per_gang.setdefault(g, []).append(p.key)
    bad += [f"gang {g} split: only {members} bound"
            for g, members in per_gang.items() if len(members) != 4]
    leaked = acct.claimed_uids() - {p.uid for p in cluster.list_pods()}
    if leaked:
        bad.append(f"leaked claims {sorted(leaked)}")
    return bad


def settle_lanes(tg, shard_set, clock, done=None, rounds: int = 64) -> int:
    """Drain every lane in a fixed order with the replayer's ``_settle``
    (cycle by cycle, never waiting on wall time: a gang left at Permit by
    a crashed front waits for the clock), then the starved-work rescue;
    a second of the held clock per round until a round moves nothing and
    leaves no lane with active work, or ``done()`` holds. Returns the
    rounds run."""
    for r in range(1, rounds + 1):
        for st in shard_set.stacks:
            tg._settle(st, clock)
        moved = shard_set.rescue_starved(min_attempts=1)
        if done is not None and done():
            return r
        if done is None and moved == 0 and all(
                st.queue.depths()[0] == 0 for st in shard_set.stacks):
            return r
        clock.advance(1.0)
    return rounds


def run_shard_crash(platform: str, size: dict, m: dict) -> dict:
    """(q2): ``TestCrossShardContention::test_shard_crash_mid_commit_
    resolves_via_resync`` through ``testing.chaos.build_cross_shard_
    contention`` at ``size``'s fleet: a plain gang of 4 x 4 chips, the
    process crashed mid-commit at its second bind, a respawned assembly
    over the same backing cluster resynced and drained until the gang is
    bound; lane after lane on a held clock (:func:`settle_lanes`)."""
    chaos, config, tg = m["chaos"], m["config"], m["tracegen"]
    clock = SteppedClock(0.0)
    cfg = config.SchedulerConfig(shard_count=size["shards"], batch_requests=8,
                                 failover_adopt_window_s=0.0)
    plan = chaos.ChaosPlan([chaos.FaultSpec(op="shard_crash", at=1, kind="mid_commit")])
    t0 = time.monotonic()
    with StackTap(m, platform, clock) as tap:
        ss, _agent, contended = chaos.build_cross_shard_contention(
            CRASH_SEED, shards=size["shards"], contended_slices=size["contended"],
            hosts=size["contention_hosts"], plan=plan, config=cfg)
        front = ss.global_stack.cluster
        labels = {"tpu/gang": "xg", "tpu/gang-size": "4", "tpu/chips": "4"}
        for i in range(4):
            front.create_pod(m["types"].PodSpec(f"xg-{i}", labels=dict(labels)))
        settle_lanes(tg, ss, clock, rounds=12)
        crashed = front.crashed.is_set()
        fired = [list(f) for f in plan.fired]
        ss.close()
        front2 = front.respawn()
        ss2 = m["standalone"].build_sharded_stacks(cluster=front2, config=cfg)
        resync = ss2.global_stack.reconciler.resync()

        def whole() -> bool:
            return all(p.node_name for p in front2.inner.list_pods())

        rounds = settle_lanes(tg, ss2, clock, whole)
        bindings = {p.key: p.node_name for p in front2.inner.list_pods()}
        violations = contention_invariants(ss2)
        staged = sorted(ss2.accountant.staged_uids())
        ss2.close()
    return {
        "crashed": crashed, "fired": fired, "contended": contended,
        "bindings": bindings, "violations": violations, "staged": staged,
        "rounds": rounds, "resync": {"adopted": list(resync.adopted_gangs),
                   "rolled_back": list(resync.rolled_back_gangs)},
        "wall_s": time.monotonic() - t0, "devices": tap.devices(),
    }


def run_storm(platform: str, m: dict) -> dict:
    """(q3): ``tests/test_overload.py``'s ``TestOverloadStormSweep`` (seed
    1337, 8 storm rounds, then calm) through ``testing.chaos.build_
    overload_storm`` at its own 4-host fleet, with the sweep's
    invariants; returns the ladder's level after each round, the shed
    count and every pod's first node."""
    chaos, overload = m["chaos"], m["overload"]
    t0 = time.monotonic()
    with StackTap(m, platform) as tap:
        stack, _agent, clock = chaos.build_overload_storm(STORM_SEED)
    ov, cluster = stack.metrics.overload, stack.cluster
    created: list = []
    prod_created: dict = {}
    bound_rounds: dict = {}
    first_node: dict = {}
    levels: list = []
    violations: list = []

    def note_bound(key, r) -> None:
        pod = cluster.get_pod(key)
        if pod is not None and pod.node_name:
            bound_rounds.setdefault(key, r)
            first_node.setdefault(key, pod.node_name)

    peak = 0
    for r in range(STORM_ROUNDS):
        prod_pods, spot_pods = chaos.storm_stream(STORM_SEED, r)
        for p in prod_pods + spot_pods:
            cluster.create_pod(p)
            created.append(p.key)
        for p in prod_pods:
            prod_created[p.key] = r
        clock.now += 2.0
        ov.evaluate()
        stack.scheduler.run_until_idle(max_wall_s=10.0)
        peak = max(peak, ov.level_idx)
        levels.append(ov.level_idx)
        for key in list(bound_rounds):
            if r - bound_rounds[key] >= 2:
                cluster.delete_pod(key)
                created.remove(key)
                del bound_rounds[key]
        for key in created:
            note_bound(key, r)
        for ni in stack.informer.snapshot().infos():
            if stack.accountant.chips_in_use(ni.name) > len(ni.tpu.healthy_chips()):
                violations.append(f"round {r}: {ni.name} oversubscribed")
        for key, r0 in prod_created.items():
            pod = cluster.get_pod(key)
            if pod is not None and r - r0 >= 2 and not pod.node_name:
                violations.append(f"round {r}: prod pod {key} waited past 2 rounds")
    storm_shed = ov.shed_total
    calm = 0
    for calm in range(1, 101):
        clock.now += 5.0
        ov.evaluate()
        stack.scheduler.run_until_idle(max_wall_s=10.0)
        levels.append(ov.level_idx)
        for key in list(bound_rounds):
            cluster.delete_pod(key)
            created.remove(key)
            del bound_rounds[key]
        for key in created:
            note_bound(key, 99)
        if ov.level_idx == overload.NOMINAL and not created:
            break
    out = {
        "levels": levels, "peak": peak, "shed_total": ov.shed_total,
        "storm_shed": storm_shed, "calm_rounds": calm, "left": len(created),
        "final_level": ov.level_idx, "sample_rate": stack.metrics.tracer.sample_rate,
        "staged": sorted(stack.accountant.staged_uids()), "bindings": first_node,
        "violations": violations, "shed_level": overload.SHED,
        "wall_s": time.monotonic() - t0, "devices": tap.devices(),
    }
    stack.gang.close()
    return out


def run_chaos(platform: str, size: dict = CHAOS_FULL, *, reported: bool = True,
              mods: "dict | None" = None, parts=("q1", "q2", "q3")) -> dict:
    """Run (q): (q1) the trace replay, (q2) the shard crash mid-commit and
    (q3) the overload storm on ``platform`` (those of ``parts``). On the
    card every ``fleet_eval`` / ``joint_fit`` / ``update_rows`` launch is
    held against its plain version, the counts zeroed just before each
    part."""
    m = mods or port_testing()
    out: dict = {}
    for part, fn, args in (("q1", run_replay, (size,)), ("q2", run_shard_crash, (size,)),
                           ("q3", run_storm, ())):
        if part not in parts:
            continue
        if mods is None:
            with KeptKernels() as kept, KeptRowUpdates() as rows:
                out[part] = fn(platform, *args, m)
            out[part]["kernels"] = kept_counts(kept, rows)
        else:
            out[part] = fn(platform, *args, m)
    return out


CHAOS_PARITY = {
    "q1": ("fingerprint", "counts", "slo", "binds"),
    "q2": ("crashed", "fired", "resync", "rounds", "bindings", "staged"),
    "q3": ("levels", "peak", "shed_total", "storm_shed", "calm_rounds", "bindings"),
}


def check_chaos_run(run: dict, card: bool) -> None:
    """One run (q)'s own gates, for the parts it ran: the replay bound pods
    and killed hosts, the crash fired and the respawned assembly completed
    the gang whole, the storm reached SHED, shed pods and came back to
    NOMINAL with nothing left; on the card every stack evaluated there,
    every part launched fleet_eval and every launch equals its plain
    version."""
    q1, q2, q3 = run.get("q1"), run.get("q2"), run.get("q3")
    if q1 is not None and (q1["counts"]["binds"] <= 0 or not q1["counts"]["killed_nodes"]):
        raise AssertionError(f"run q1: nothing bound or no host killed: {q1['counts']}")
    if q2 is not None:
        if not q2["crashed"] or q2["violations"] or q2["staged"]:
            raise AssertionError(f"run q2: crashed {q2['crashed']}, violations "
                                 f"{q2['violations']}, staged {q2['staged']}")
        xg = [node for key, node in q2["bindings"].items() if key.startswith("default/xg-")]
        if len(xg) != 4 or not all(xg):
            raise AssertionError(f"run q2: gang xg not whole after the respawn: {xg}")
    if q3 is not None and (
            q3["peak"] != q3["shed_level"] or q3["shed_total"] <= 0 or q3["left"]
            or q3["final_level"] != 0 or q3["sample_rate"] != 1.0 or q3["staged"]
            or q3["violations"]):
        raise AssertionError(f"run q3: peak {q3['peak']}, shed {q3['shed_total']}, left "
                             f"{q3['left']}, level {q3['final_level']}, violations "
                             f"{q3['violations'][:4]}")
    if not card:
        return
    for part, r in run.items():
        if r["devices"] != ["cuda:0"]:
            raise AssertionError(f"run {part}: stacks evaluated on {r['devices']}")
        k = r["kernels"]
        if k["launches"]["fleet_eval"] <= 0:
            raise AssertionError(f"run {part}: fleet_eval never launched")
        for name in ("fleet_eval", "joint_fit", "update_rows"):
            if k["kept"][name] != k["launches"][name] or k["max_abs_err"][name]:
                raise AssertionError(f"run {part} {name}: {k['kept'][name]} of "
                                     f"{k['launches'][name]} launches held, largest "
                                     f"difference {k['max_abs_err'][name]}")


def check_chaos(g: dict, c: dict) -> None:
    """Run (q) on the card against its CPU run."""
    check_chaos_run(g, card=True)
    check_chaos_run(c, card=False)
    for part, keys in CHAOS_PARITY.items():
        bad = [k for k in keys if g[part][k] != c[part][k]]
        if bad:
            raise AssertionError(f"run {part}: cuda != cpu in {bad}")


def print_chaos(run: dict, smi: str) -> None:
    q1, q2, q3 = run["q1"], run["q2"], run["q3"]
    print(f"run (q1) replay: {json.dumps(q1['counts'])} slo {q1['verdict']} "
          f"fleet p99 {q1['fingerprint']['fleet_p99_s']} s, "
          f"{q1['pods_per_s']:.1f} pods/s over {q1['wall_s']:.1f} s | {smi}")
    print(f"run (q2) shard crash: fired {q2['fired']}, xg on "
          f"{sorted(n for k, n in q2['bindings'].items() if k.startswith('default/xg-'))}, "
          f"{q2['wall_s']:.1f} s | {smi}")
    print(f"run (q3) storm: levels {q3['levels']}, shed {q3['shed_total']}, "
          f"{len(q3['bindings'])} pods bound, {q3['wall_s']:.1f} s | {smi}")
    if "kernels" in q1:
        print("run (q) launches:", json.dumps(
            {p: run[p]["kernels"]["launches"] for p in ("q1", "q2", "q3")}))


def phase_chaos(smi: str, rerun: "SpawnedRerun") -> dict:
    """Run (q) on the card; its CPU run is ``rerun``, spawned before run
    (m), whose loop-mode and sharded runs and run (o)'s stepped drives it
    overlaps."""
    g = run_chaos("auto")
    c = rerun.result()
    print_chaos(g, smi)
    print_chaos(c, smi)
    check_chaos(g, c)
    return g


# --- run (r): federation and the node agent ---------------------------------

# (r1): two cluster fronts, each the 5,000-node fleet. ``train`` v5e hosts
# a front keeps for the federated plain gangs (Node label pool=train and a
# dedicated=train NoSchedule taint the gangs tolerate, so no singleton
# takes them): home's fit ``home_train // plain_size`` gangs, the
# secondary's ``remote_train // plain_size``. Every home v5p slice holds a
# one-chip occupant on its first host (bound before the run, adopted by
# the first resync), so no 2x2x1 block is left at home; the secondary
# keeps ``remote_free_slices`` whole slices (a seeded choice). ``wave1``
# is run (c)'s first wave as ``gang_script`` cuts it; ``partition_at``
# names the migration whose first create partitions the secondary;
# ``remote_local`` singletons bind on the secondary before the partition,
# ``dead`` of them are deleted and ``era`` created while it lasts.
# (r2): the federated CLI over run (l)'s API server process at
# ``cli_fleet``, ``cli_singles`` singletons. (r3): ``agents`` native
# agents (the fleet's v5e pool) and ``agent_singles`` of run (b)'s
# singletons in each of two rounds.
FEDERATION_FULL = dict(
    slices=512, v5e_hosts=2952, home_train=32, remote_train=48, remote_free_slices=12,
    plain=8, plain_size=16, topo=8,
    wave1=dict(plain=8, plain_size=16, cosched=4, topo=0, multi=0, singles=64),
    singles_b=256, remote_local=16, dead=4, era=8, partition_at=3,
    cli_fleet=dict(slices=512, v5e_hosts=2952), cli_remote=dict(slices=8, v5e_hosts=40),
    cli_singles=64, agents=2952, agent_slices=512, agent_singles=256,
)
FEDERATION_SMALL = dict(
    slices=16, v5e_hosts=96, home_train=8, remote_train=12, remote_free_slices=6,
    plain=8, plain_size=4, topo=4,
    wave1=dict(plain=2, plain_size=4, cosched=2, topo=0, multi=0, singles=16),
    singles_b=32, remote_local=8, dead=2, era=4, partition_at=3,
    cli_fleet=dict(slices=8, v5e_hosts=40), cli_remote=dict(slices=4, v5e_hosts=8),
    cli_singles=16, agents=96, agent_slices=16, agent_singles=32,
)
# Health thresholds on (r1)'s held clock and in (r2)'s config (seconds).
FED_THRESHOLDS = dict(federation_degraded_after_s=5.0, federation_partitioned_after_s=10.0,
                      federation_lost_after_s=30.0)
FED_CLI_THRESHOLDS = dict(federation_degraded_after_s=0.5,
                          federation_partitioned_after_s=1.0,
                          federation_lost_after_s=2.0, federation_probe_period_s=0.2)
FED_STEP_S = 4.0      # the held clock's step between two health passes
FED_SERIES = ("yoda_cluster_state", "yoda_cluster_transitions_total",
              "yoda_spillover_gangs_total")
TRAIN_TAINT = ("dedicated", "train")
FED_RUN_DIR = "build/run_r"
R1_PARITY = ("bindings", "states", "migrations", "passes", "series", "ledger_kept",
             "resync", "gangs")
R3_PARITY = ("bindings", "crs", "charged")
AGENT_SPEC = "generation=v5e;chips=8"


def port_federation() -> dict:
    """The modules run (r) drives: the port's (the tests pass the JAX
    package's under the same keys)."""
    import yoda_tpu_torch.agent.fake_publisher as fake_publisher
    import yoda_tpu_torch.agent.native as native
    import yoda_tpu_torch.api.requests as requests
    import yoda_tpu_torch.api.types as types
    import yoda_tpu_torch.config as config
    import yoda_tpu_torch.federation as federation
    import yoda_tpu_torch.federation.federation as fed_impl
    import yoda_tpu_torch.standalone as standalone
    from yoda_tpu_torch.testing import chaos

    return {"standalone": standalone, "config": config, "types": types, "chaos": chaos,
            "requests": requests,
            "fake_publisher": fake_publisher, "native": native, "federation": federation,
            "fed_impl": fed_impl}


def federation_front(m: dict, size: dict, *, home: bool, seed: int):
    """One cluster front of run (r1): a ``ChaosCluster`` over a
    ``FakeCluster`` holding the 5,000-node layout of ``build_fleet``, every
    host with a Node object, the seeded ``train`` v5e hosts labelled and
    tainted, and the v5p occupants bound in the store (see
    ``FEDERATION_FULL``). Returns (front, train hosts, free slices)."""
    types = m["types"]
    front = m["chaos"].ChaosCluster()
    inner = front.inner
    agent = m["fake_publisher"].FakeTpuAgent(inner)
    slices = {}
    for s in range(size["slices"]):
        slices[f"v5p-{s:03d}"] = agent.add_slice(f"v5p-{s:03d}", generation="v5p",
                                                 host_topology=(2, 2, 1))
    v5e = [f"v5e-{h:04d}" for h in range(size["v5e_hosts"])]
    for name in v5e:
        agent.add_host(name, generation="v5e", chips=8)
    rng = np.random.default_rng(seed)
    n_train = size["home_train"] if home else size["remote_train"]
    train = sorted(v5e[i] for i in rng.permutation(len(v5e))[:n_train])
    free = [] if home else sorted(
        str(s) for s in rng.choice(sorted(slices), size["remote_free_slices"], replace=False))
    taint = types.Taint(TRAIN_TAINT[0], TRAIN_TAINT[1])
    for hosts in slices.values():
        for name in hosts:
            inner.put_node(types.K8sNode(name, labels={"pool": "v5p"}))
    for name in v5e:
        inner.put_node(types.K8sNode(name, labels={"pool": "train"}, taints=[taint])
                       if name in train else types.K8sNode(name, labels={"pool": "v5e"}))
    agent.publish_all()
    for s, hosts in sorted(slices.items()):
        if s in free:
            continue
        occ = types.PodSpec(f"occ-{s}", labels={"tpu/chips": "1"}, uid=f"occ-{s}")
        inner.create_pod(occ)
        inner.bind_pod(occ.key, sorted(hosts)[0])
    return front, train, free


def fed_pods(m: dict, size: dict) -> "tuple[list, list, dict]":
    """The federated gangs (``plain`` plain gangs of ``plain_size`` v5e x 8
    chips bound for the train hosts, ``topo`` 2x2x1 topology gangs of 4 v5p
    x 4 chips) as PodSpecs, plain gangs first; and name -> size."""
    types = m["types"]
    tol = [types.Toleration(key=TRAIN_TAINT[0], value=TRAIN_TAINT[1])]
    plain, topo, gangs = [], [], {}
    for g in range(size["plain"]):
        name = f"fed-p{g}"
        gangs[name] = size["plain_size"]
        plain += [types.PodSpec(f"{name}-{i:02d}", uid=f"{name}-{i:02d}", labels={
            "tpu/gang": name, "tpu/gang-size": str(size["plain_size"]), "tpu/chips": "8",
            "tpu/generation": "v5e"}, node_selector={"pool": "train"}, tolerations=list(tol))
                  for i in range(size["plain_size"])]
    for g in range(size["topo"]):
        name = f"fed-t{g}"
        gangs[name] = 4
        topo += [types.PodSpec(f"{name}-{i}", uid=f"{name}-{i}", labels={
            "tpu/gang": name, "tpu/topology": "2x2x1", "tpu/chips": "4",
            "tpu/generation": "v5p"}) for i in range(4)]
    return plain, topo, gangs


def singleton_specs(m: dict, pods, prefix: str) -> list:
    return [m["types"].PodSpec(f"{prefix}{n}", uid=f"{prefix}{n}", labels=dict(labels))
            for n, labels in pods]


class FedLog:
    """Run (r1)'s event log, in order: every bind through a front (its
    member's fence verdict at that instant, the monotonic time), every
    completed resync, the heal, and each migration's first create on the
    target."""

    def __init__(self, fed) -> None:
        self.rows: list = []
        self.migrated_at: dict = {}
        for member in fed.members:
            self._wrap(member)

    def _wrap(self, member) -> None:
        front, rows = member.cluster, self.rows
        real_bind = front.bind_pod
        real_resync = member.stack.reconciler.resync

        def bind_pod(key, node):
            rows.append(("bind", member.name, key, bool(member.stack.scheduler.fence_fn()),
                         time.monotonic()))
            return real_bind(key, node)

        def resync():
            out = real_resync()
            rows.append(("resync", member.name))
            return out

        front.bind_pod, member.stack.reconciler.resync = bind_pod, resync

    def mark(self, what: str) -> None:
        self.rows.append((what,))

    def binds(self, name: str) -> list:
        return [r for r in self.rows if r[0] == "bind" and r[1] == name]


def partition_on_create(front, log: FedLog, at: int) -> dict:
    """Partition ``front`` at the first create of the ``at``-th gang the
    spillover migrates to it (a create mid-pass: that gang's migration
    rolls back whole, the gangs migrated before it stay); records each
    migrated gang's first create instant. Returns the state."""
    state = {"gangs": [], "fired": None}
    real = front.create_pod

    def create_pod(pod):
        gang = pod.labels.get("tpu/gang")
        if gang is not None and gang not in state["gangs"]:
            state["gangs"].append(gang)
            log.migrated_at.setdefault(gang, time.monotonic())
            if len(state["gangs"]) == at and state["fired"] is None:
                state["fired"] = gang
                front.partition()
        return real(pod)

    front.create_pod = create_pod
    return state


def fed_series(fed) -> list:
    """The federation's metric samples (``FED_SERIES``), sorted."""
    return sorted(line for line in fed.metrics.registry.render_prometheus().splitlines()
                  if line.split("{")[0].split(" ")[0] in FED_SERIES)


def cluster_bindings(front) -> dict:
    """Every pod of the front's backing store but the occupants: name ->
    node (None while pending)."""
    return {p.name: p.node_name for p in front.inner.list_pods()
            if not p.name.startswith("occ-")}


def gang_ledger(m: dict, fed, gangs: dict) -> dict:
    """Per gang of ``gangs``: each cluster holding pods of it, with its pods
    and how many of them are bound there."""
    out: dict = {}
    for member in fed.members:
        for p in member.cluster.inner.list_pods():
            g = m["requests"].gang_name_of(p.labels)
            if g in gangs:
                row = out.setdefault(g, {}).setdefault(member.name, [0, 0])
                row[0] += 1
                row[1] += p.node_name is not None
    return {g: {c: tuple(v) for c, v in sorted(rows.items())} for g, rows in sorted(out.items())}


def stack_kernels(stack) -> list:
    """A stack's kernel objects that count their launches: the serve
    path's (the port's ``TorchFleetKernel``) and the speculative cache's
    private one; none on a stack that counts nothing."""
    kernels = (getattr(getattr(stack, "batch", None), "_kern", None),
               getattr(getattr(stack, "speculation", None), "kernel", None))
    return [k for k in kernels if hasattr(k, "launches")]


def kernel_counts(stack) -> dict:
    """The launches a stack's own kernel objects counted (0 where they
    count none, as on the host)."""
    kernels = stack_kernels(stack)
    return {"fleet_eval": sum(k.launches for k in kernels),
            "joint_fit": sum(getattr(k, "joint_fit_launches", 0) for k in kernels),
            "update_rows": sum(k.row_updates for k in kernels)}


def zero_counts(stack) -> None:
    for kern in stack_kernels(stack):
        kern.launches = kern.row_updates = 0
        if hasattr(kern, "joint_fit_launches"):
            kern.joint_fit_launches = 0


def stack_device(stack) -> str:
    return str(getattr(getattr(stack, "batch", None), "device", "none"))


def drain_member(member, waiting: list, max_wall_s: float = 300.0) -> None:
    """Drain one member's queue on the held clock; a member left with pods
    at Permit (which only the held clock could expire) is recorded."""
    member.stack.scheduler.run_until_idle(max_wall_s=max_wall_s)
    left = member.stack.framework.waiting_pods()
    if left:
        waiting.append([member.name, len(left)])


def run_federation_stepped(platform: str, size: dict, m: dict) -> dict:
    """(r1): ``build_federation`` over two fronts (home, then the
    secondary) on a held clock, driven by hand: a health pass, run (c)'s
    first wave at home and the secondary's local singletons; the
    federated plain gangs, then the topology gangs, at home; a spillover
    pass whose ``partition_at``-th migration partitions the secondary at
    its first create; health passes every ``FED_STEP_S`` of the clock
    until the secondary is LOST, home binding run (b)'s singletons once it
    is fenced while external actors delete ``dead`` of the secondary's
    bound pods and create ``era`` more there; the heal, a health pass (the
    rejoin resync), the secondary's drain, a second spillover pass and the
    secondary's drain."""
    cfg = m["config"].SchedulerConfig(kernel_platform=platform, batch_requests=16,
                                      **FED_THRESHOLDS)
    ClusterState = m["federation"].ClusterState
    clock = SteppedClock(1000.0)
    t0 = time.monotonic()
    home, home_train, _ = federation_front(m, size, home=True, seed=31)
    remote, remote_train, free_slices = federation_front(m, size, home=False, seed=32)
    fed = m["standalone"].build_federation([("home", home), ("remote", remote)], cfg,
                                           clock=clock)
    build_s = time.monotonic() - t0
    hm, rm = fed.members
    for member in fed.members:
        zero_counts(member.stack)
    log = FedLog(fed)
    waiting: list = []
    states: list = []
    health_ms: list = []
    spill_ms: list = []
    passes: list = []

    def health_pass():
        t = time.monotonic()
        got = fed.health_pass()
        health_ms.append(1e3 * (time.monotonic() - t))
        states.append({k: v.value for k, v in got.items()})
        return got

    def spillover(what: str):
        t = time.monotonic()
        n = fed.spillover_pass()
        spill_ms.append(1e3 * (time.monotonic() - t))
        passes.append([what, n])
        return n

    health_pass()
    waves, wave_gangs = gang_script(seed=1, **size["wave1"])
    for name, labels, _sel in waves[0]:
        home.create_pod(m["types"].PodSpec(name, uid=name, labels=dict(labels)))
    drain_member(hm, waiting)
    local = singleton_specs(m, fleet_and_pods(33)[1][: size["remote_local"]], "local-")
    for p in local:
        remote.create_pod(p)
    drain_member(rm, waiting)
    plain, topo, gangs = fed_pods(m, size)
    gangs.update({g: n for g, (_kind, n) in wave_gangs.items()})
    for p in plain:
        home.create_pod(p)
    drain_member(hm, waiting)
    for p in topo:
        home.create_pod(p)
    drain_member(hm, waiting)
    home_gangs_bound = sorted(g for g, rows in gang_ledger(m, fed, gangs).items()
                              if rows.get("home", (0, 0))[1] == gangs[g])
    injected = partition_on_create(remote, log, size["partition_at"])
    spillover("pass 1, the partition mid-pass")
    after_pass1 = gang_ledger(m, fed, gangs)
    victim = injected["fired"]
    singles_b = singleton_specs(m, fleet_and_pods(0)[1][: size["singles_b"]], "b-")
    b_created = era_done = False
    while True:
        clock.advance(FED_STEP_S)
        got = health_pass()
        if not got["remote"].serving and not b_created:
            # The secondary is fenced: home keeps serving, and the world
            # moves on behind the partition (its events never arrive).
            b_created = True
            for p in singles_b:
                home.create_pod(p)
            drain_member(hm, waiting)
        if got["remote"] is ClusterState.PARTITIONED and not era_done:
            era_done = True
            bound_local = sorted(k for k, v in cluster_bindings(remote).items()
                                 if k.startswith("local-") and v)
            for name in bound_local[: size["dead"]]:
                remote.inner.delete_pod(f"default/{name}")
            for p in singleton_specs(m, fleet_and_pods(34)[1][: size["era"]], "era-"):
                remote.inner.create_pod(p)
        if got["remote"] is ClusterState.LOST or len(states) > 40:
            break
    claimed_before_heal = len(rm.stack.accountant.claimed_uids())
    remote.heal()
    log.mark("heal")
    health_pass()
    resync_report = {"resynced": rm.stack.reconciler.resynced.is_set(),
                     "claimed_before": claimed_before_heal,
                     "claimed_after": len(rm.stack.accountant.claimed_uids())}
    drain_member(rm, waiting)
    spillover("pass 2, after the rejoin")
    ledger_kept = sorted(
        g for g, rows in gang_ledger(m, fed, gangs).items()
        if set(rows) == {"home"} and rows["home"][1] == 0
        and m["fed_impl"]._gang_fits(
            rm.stack,
            [p for p in home.inner.list_pods() if p.labels.get("tpu/gang") == g], {}))
    drain_member(rm, waiting)
    drain_member(hm, waiting)
    health_pass()
    wall_s = time.monotonic() - t0
    live_remote = {p.uid for p in remote.inner.list_pods()}
    resync_report["leaked"] = sorted(rm.stack.accountant.claimed_uids() - live_remote)
    over = []
    for member in fed.members:
        inner = member.cluster.inner
        for t in inner.list_tpu_metrics():
            if member.stack.accountant.chips_in_use(t.name) > sum(c.healthy for c in t.chips):
                over.append(f"{member.name}/{t.name}")
    bindings = {member.name: cluster_bindings(member.cluster) for member in fed.members}
    both = sorted(set(k for k, v in bindings["home"].items() if v)
                  & set(k for k, v in bindings["remote"].items() if v))
    rows = log.rows
    heal_at = rows.index(("heal",))
    after = rows[heal_at:]
    first_bind = next((i for i, r in enumerate(after) if r[0] == "bind" and r[1] == "remote"),
                      None)
    first_resync = next((i for i, r in enumerate(after) if r == ("resync", "remote")), None)
    last_bind_at: dict = {}
    for r in rows:
        if r[0] == "bind" and r[1] == "remote":
            g = r[2].split("/")[-1].rsplit("-", 1)[0]
            last_bind_at[g] = r[4]
    completion_ms = {g: 1e3 * (last_bind_at[g] - t) for g, t in log.migrated_at.items()
                     if g in last_bind_at}
    ledger = gang_ledger(m, fed, gangs)
    member_launches = {member.name: kernel_counts(member.stack) for member in fed.members}
    member_dispatch = {member.name: stack_dispatch(member.stack) for member in fed.members}
    devices = sorted({stack_device(member.stack) for member in fed.members})
    for member in fed.members:
        close_stack(member.stack)
    return {
        "bindings": bindings, "states": states, "passes": passes,
        "migrations": fed.spillover_gangs, "series": fed_series(fed),
        "ledger_kept": ledger_kept, "resync": resync_report, "gangs": ledger,
        "home_gangs_bound": home_gangs_bound, "victim": victim,
        "victim_after_pass1": after_pass1.get(victim),
        "injected": injected["gangs"], "free_slices": free_slices,
        "train": {"home": home_train, "remote": remote_train},
        "fenced_binds": [list(r[:3]) for r in rows if r[0] == "bind" and not r[3]],
        "waiting": waiting, "sizes": gangs, "wave_gangs": sorted(wave_gangs),
        "bound_twice": both, "over": over,
        "resync_before_bind": first_resync is not None and (
            first_bind is None or first_resync < first_bind),
        "remote_binds_after_heal": sum(1 for r in after if r[0] == "bind" and r[1] == "remote"),
        "health_ms": health_ms, "spillover_ms": spill_ms, "completion_ms": completion_ms,
        "member_launches": member_launches, "member_dispatch": member_dispatch,
        "devices": devices,
        "nodes": {member.name: len(member.stack.informer.snapshot()) for member in fed.members},
        "build_s": build_s, "wall_s": wall_s,
    }


def run_fed_cli(platform: str, size: dict) -> dict:
    """(r2): ``python -m yoda_tpu_torch.cli --federate-url remote=URL`` on a
    thread (``Replicas``) at default settings with ``FED_CLI_THRESHOLDS``
    in its config: run (l)'s API server process at ``cli_fleet`` is home;
    a second server process (``cli_remote``) boots and is stopped before
    the CLI dials it. ``cli_singles`` of run (b)'s singletons over HTTP once
    ``/readyz`` answers 200; then a ``--agent --node-name agent-0`` process
    under ``YODA_TPUINFO_SPEC`` (a v6e host of 8 chips) publishes its CR to
    home (its Node object put there as the kubelet would) and a v6e pod,
    which only that host satisfies, binds there."""
    from yoda_tpu_torch.api.types import K8sNode

    os.makedirs(FED_RUN_DIR, exist_ok=True)
    cfg_path = os.path.join(FED_RUN_DIR, f"cli-{platform}.yaml")
    with open(cfg_path, "w") as f:
        f.write("".join(f"{k}: {v}\n" for k, v in FED_CLI_THRESHOLDS.items()))
    with ApiServerProcess(size["cli_remote"]) as dead:
        dead_url = dead.base_url
    singles = fleet_and_pods(0)[1][: size["cli_singles"]]
    pods = [(f"r2-{n}", labels) for n, labels in singles]
    labels_of = {f"default/{n}": lab for n, lab in pods}
    port = free_port()
    argv = ["--config", cfg_path, "--metrics-port", str(port),
            "--federate-url", f"remote={dead_url}"] + (
        ["--device", "cpu"] if platform == "cpu" else [])
    fed_box: list = []
    remote_writes: list = []
    sync_s: dict = {}
    with ApiServerProcess(size["cli_fleet"]) as server:
        client = seed_client(server)
        with KeptKernels() as kept, KeptRowUpdates() as rows, \
                Replicas(server.base_url) as reps:
            real_fed = reps.standalone.build_federation
            real_sync = reps.cli._build_kube_cluster

            def build_federation(*a, **kw):
                fed = real_fed(*a, **kw)
                fed_box.append(fed)
                return fed

            def build_kube_cluster(*a, **kw):
                t = time.monotonic()
                cluster = real_sync(*a, **kw)
                sync_s[kw.get("url") or "home"] = time.monotonic() - t
                if kw.get("url"):
                    request = cluster.api.request

                    def logged(method, path, *ra, **rkw):
                        if method != "GET":
                            remote_writes.append([method, path])
                        return request(method, path, *ra, **rkw)

                    cluster.api.request = logged
                return cluster

            reps.standalone.build_federation = build_federation
            reps.cli._build_kube_cluster = build_kube_cluster
            try:
                t_start = time.monotonic()
                reps.start("r2", argv)
                base = f"http://127.0.0.1:{port}"
                t_ready = wait_for(lambda: http_get(f"{base}/readyz")[0] == 200, 300,
                                   "/readyz 200 with a dead remote")
                created = create_pods(client, pods)
                wait_for(lambda: all(v is not None for v in server.bound(labels_of).values()),
                         180, "every r2 singleton bound", poll_s=0.05)
                bound = server.bound(labels_of)
                wait_for(lambda: scrape(port).get('yoda_cluster_state{cluster="remote"}') == 3.0,
                         60, "the remote at LOST on /metrics")
                # The kubelet registers the agent's Node; the agent process
                # publishes its TpuNodeMetrics CR.
                server.put_object("Node", "agent-0", K8sNode(
                    "agent-0", labels={HOST_KEY: "agent-0", "pool": "v6e"}).to_obj())
                env = dict(os.environ, YODA_KUBE_API_URL=server.base_url,
                           YODA_TPUINFO_SPEC="generation=v6e;chips=8")
                env["PYTHONPATH"] = os.getcwd() + os.pathsep + env.get("PYTHONPATH", "")
                agent = subprocess.Popen(
                    [sys.executable, "-m", "yoda_tpu_torch.cli", "--agent", "--node-name",
                     "agent-0", "--interval-s", "1"],
                    env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
                try:
                    t_agent = time.monotonic()
                    wait_for(lambda: server.get_object("TpuNodeMetrics", "agent-0") is not None,
                             120, "agent-0's CR at home")
                    agent_cr_s = time.monotonic() - t_agent
                    create_pods(client, [("r2-agent-pod", {"tpu/generation": "v6e",
                                                           "tpu/chips": "8"})])
                    wait_for(lambda: server.bound(["default/r2-agent-pod"])[
                        "default/r2-agent-pod"] is not None, 60, "the v6e pod bound")
                    agent_pod = server.bound(["default/r2-agent-pod"])["default/r2-agent-pod"]
                finally:
                    agent.terminate()
                    try:
                        _out, agent_err = agent.communicate(timeout=30)
                    except subprocess.TimeoutExpired:
                        agent.kill()
                        _out, agent_err = agent.communicate()
                cr = server.get_object("TpuNodeMetrics", "agent-0")["status"]
                values = scrape(port)
                fed = fed_box[0]
                states = {m.name: m.health.state.value for m in fed.members}
                members = {m.name: dict(device=stack_device(m.stack),
                                        **kernel_counts(m.stack))
                           for m in fed.members}
                reps.stop("r2")
                rc = reps.rc.get("r2")
            finally:
                reps.standalone.build_federation = real_fed
        log = server.bindings()
    posts, bound_at, conflicts = binding_counts(log)
    used: dict = {}
    for key, node in bound.items():
        used[node] = used.get(node, 0) + int(labels_of[key].get("tpu/chips", "1"))
    return dict(
        platform=platform, rc=rc, nodes=server.nodes, pods=len(pods),
        bound=sum(v is not None for v in bound.values()),
        over=sorted(h for h, n in used.items() if n > server.capacity[h]),
        double_posts=sorted(k for k, n in posts.items() if n > 1), conflicts=conflicts,
        start_to_ready_s=t_ready - t_start, sync_s=sync_s,
        remote_sync_s=sync_s.get(dead_url), remote_writes=remote_writes,
        remote_state=values.get('yoda_cluster_state{cluster="remote"}'),
        home_state=values.get('yoda_cluster_state{cluster="home"}'), states=states,
        agent_rc=agent.returncode, agent_err=agent_err[-2000:], agent_cr_s=agent_cr_s,
        agent_cr={k: cr[k] for k in ("generation", "chipCount", "source", "accelType")},
        agent_pod=agent_pod, members=members,
        devices=sorted({v["device"] for v in members.values()}),
        p99_ms=pct_ms(sorted(bound_at[k] - created[k] for k in labels_of if k in bound_at),
                      0.99),
        kernels=kept_counts(kept, rows),
    )


def cr_view(tpu) -> dict:
    """A CR as the API holds it, less its publish stamp and version."""
    obj = tpu.to_obj()
    obj["metadata"].pop("resourceVersion", None)
    obj["status"].pop("lastUpdatedUnix", None)
    return obj


def run_agents(platform: str, size: dict, m: dict) -> dict:
    """(r3): a default stack (K = 16) over ``agent_slices`` v5p slices from
    the fake agent and ``agents`` v5e hosts, each published by a
    ``NativeTpuAgent`` through the native library under
    ``YODA_TPUINFO_SPEC`` (``AGENT_SPEC``); ``agent_singles`` of run (b)'s
    singletons bind on those CRs; every agent's next ``run_once`` charges
    its bound pods' HBM into its CR; a second ``agent_singles`` (another
    seed) bind against the charged CRs."""
    native = m["native"]
    lib = native.load_library(m.get("tpuinfo_lib"))
    if lib is None:
        raise AssertionError("no native metrics library (no g++ to build native/)")
    cfg = m["config"].SchedulerConfig(kernel_platform=platform, batch_requests=16)
    saved = os.environ.get("YODA_TPUINFO_SPEC")
    os.environ["YODA_TPUINFO_SPEC"] = AGENT_SPEC
    try:
        stack = m["standalone"].build_stack(config=cfg)
        fake = m["fake_publisher"].FakeTpuAgent(stack.cluster)
        for s in range(size["agent_slices"]):
            fake.add_slice(f"v5p-{s:03d}", generation="v5p", host_topology=(2, 2, 1))
        fake.publish_all()
        agents = [native.NativeTpuAgent(stack.cluster, f"v5e-{h:04d}", lib=lib)
                  for h in range(size["agents"])]
        zero_counts(stack)
        out: dict = {"run_once_ms": [], "drain_s": [], "sources": set()}
        names: list = []
        for round_, seed in ((1, 0), (2, 5)):
            t = time.monotonic()
            published = [a.run_once() for a in agents]
            out["run_once_ms"].append(1e3 * (time.monotonic() - t) / len(agents))
            out["sources"] |= {p.source for p in published if p is not None}
            if round_ == 2:
                import hashlib

                out["crs"] = hashlib.sha256(json.dumps(
                    [cr_view(p) for p in published], sort_keys=True).encode()).hexdigest()
                out["charged"] = sorted(p.name for p in published
                                        if p.hbm_free_sum < p.hbm_total_sum)
                fake.publish_all()
            pods = singleton_specs(m, fleet_and_pods(seed)[1][: size["agent_singles"]],
                                   f"r3-{round_}-")
            names += [p.name for p in pods]
            for p in pods:
                stack.cluster.create_pod(p)
            t = time.monotonic()
            stack.scheduler.run_until_idle(max_wall_s=600)
            out["drain_s"].append(time.monotonic() - t)
        bindings = bindings_of(stack, names)
        out.update(
            bindings=bindings, pods=len(names), bound=sum(v is not None for v in bindings.values()),
            published=sum(p is not None for p in published), sources=sorted(out["sources"]),
            over=over_capacity(stack),
            devices=[stack_device(stack)],
            member_launches={"stack": kernel_counts(stack)},
            pods_per_s=[size["agent_singles"] / s if s else None for s in out["drain_s"]],
        )
        close_stack(stack)
        return out
    finally:
        if saved is None:
            os.environ.pop("YODA_TPUINFO_SPEC", None)
        else:
            os.environ["YODA_TPUINFO_SPEC"] = saved


def run_federation(platform: str, size: dict = FEDERATION_FULL, *, reported: bool = True,
                   mods: "dict | None" = None, parts=("r1", "r2", "r3")) -> dict:
    """Run (r): (r1) the federation at full width, (r2) the federated CLI and
    the agent process, (r3) the native agents at full width, on ``platform``
    (those of ``parts``; (r2) only over the port's modules). On the card
    every ``fleet_eval`` / ``joint_fit`` / ``update_rows`` launch is held
    against its plain version, the counts zeroed just before each part."""
    m = mods or port_federation()
    runs = {"r1": run_federation_stepped, "r3": run_agents}
    out: dict = {}
    for part in parts:
        t = time.monotonic()
        if part == "r2":
            if mods is not None:
                continue  # the CLI is the port's alone
            out["r2"] = run_fed_cli(platform, size)
        elif mods is None:
            with KeptKernels() as kept, KeptRowUpdates() as rows:
                out[part] = runs[part](platform, size, m)
            out[part]["kernels"] = kept_counts(kept, rows)
        else:
            out[part] = runs[part](platform, size, m)
        out[part]["part_s"] = time.monotonic() - t
    return out


def check_federation_r1(r1: dict, size: dict) -> None:
    """(r1)'s own gates: no bind by a fenced member, none in two clusters,
    no host over its chips, every gang whole in exactly one cluster, the
    partitioned gang rolled back whole at home, the shared ledger keeping a
    gang home that fits the secondary alone, the ladder walked to LOST and
    back, the rejoin resync releasing the dropped deletions before the
    secondary's first bind, every pod of the waves bound, nothing left at
    Permit, no member stack's dispatch caught an error or demoted."""
    bad = []
    if r1["fenced_binds"]:
        bad.append(f"binds by a fenced member: {r1['fenced_binds'][:4]}")
    if r1["bound_twice"] or r1["over"] or r1["waiting"]:
        bad.append(f"bound twice {r1['bound_twice'][:4]}, over {r1['over'][:4]}, "
                   f"waiting {r1['waiting']}")
    for g, rows in r1["gangs"].items():
        (cluster, (pods, bound)), *more = rows.items()
        if more or pods != r1["sizes"][g] or bound not in (0, pods):
            bad.append(f"gang {g} not whole in one cluster: {rows}")
    if r1["victim"] is None or r1["victim_after_pass1"] != {"home": (r1["sizes"][r1["victim"]], 0)}:
        bad.append(f"partitioned migration {r1['victim']}: {r1['victim_after_pass1']}")
    if not r1["ledger_kept"]:
        bad.append("no gang kept home by the shared ledger")
    if r1["passes"][0][1] != size["partition_at"] - 1 or r1["passes"][1][1] < 1:
        bad.append(f"spillover passes {r1['passes']}")
    missing = sorted(set(r1["wave_gangs"]) - set(r1["home_gangs_bound"]))
    if missing:
        bad.append(f"run (c)'s first-wave gangs not bound at home: {missing}")
    walk = [s["remote"] for s in r1["states"]]
    seen = [w for i, w in enumerate(walk) if i == 0 or w != walk[i - 1]]
    if seen != ["up", "degraded", "partitioned", "lost", "up"] or any(
            s["home"] != "up" for s in r1["states"]):
        bad.append(f"ladder {seen}")
    res = r1["resync"]
    if not (r1["resync_before_bind"] and r1["remote_binds_after_heal"] > 0 and res["resynced"]
            and res["claimed_before"] - res["claimed_after"] == size["dead"]
            and not res["leaked"]):
        bad.append(f"rejoin: resync first {r1['resync_before_bind']}, {res}")
    unbound = sorted(k for c in ("home", "remote") for k, v in r1["bindings"][c].items()
                     if v is None and k.startswith(("b-", "local-", "era-", "spod-")))
    if unbound:
        bad.append(f"singletons unbound: {unbound[:6]}")
    for member, d in r1["member_dispatch"].items():
        if demoted(d):
            bad.append(f"member {member}'s dispatch chain: {demoted(d)}")
    if bad:
        raise AssertionError("run r1: " + "; ".join(bad))


def check_federation_r2(r2: dict, size: dict, card: bool) -> None:
    """(r2)'s gates: the remote's boot sync gave up within its 5 s, /readyz
    turned 200, home bound every singleton and the v6e pod on agent-0, the
    remote at LOST (3), nothing written to it, one binding POST per pod,
    both processes exited 0, both member stacks on the card (card)."""
    bad = []
    if r2["rc"] != 0 or r2["agent_rc"] != 0:
        bad.append(f"rc {r2['rc']}, agent rc {r2['agent_rc']}: {r2['agent_err'][-300:]}")
    if r2["remote_sync_s"] is None or r2["remote_sync_s"] > 30:
        bad.append(f"remote boot sync {r2['remote_sync_s']} s")
    if r2["bound"] != r2["pods"] or r2["over"] or r2["double_posts"] or r2["conflicts"]:
        bad.append(f"bound {r2['bound']}/{r2['pods']}, over {r2['over']}, double "
                   f"{r2['double_posts'][:4]}, 409s {r2['conflicts']}")
    if r2["agent_pod"] != "agent-0" or r2["agent_cr"]["generation"] != "v6e" \
            or r2["agent_cr"]["source"] != "env":
        bad.append(f"agent pod on {r2['agent_pod']}, CR {r2['agent_cr']}")
    if r2["remote_state"] != 3.0 or r2["home_state"] != 0.0 or r2["remote_writes"]:
        bad.append(f"remote state {r2['remote_state']}, home {r2['home_state']}, writes "
                   f"{r2['remote_writes'][:4]}")
    if card and (r2["devices"] != ["cuda:0"] or r2["members"]["home"]["fleet_eval"] <= 0):
        bad.append(f"members {r2['members']}")
    if bad:
        raise AssertionError("run r2: " + "; ".join(bad))


def check_federation_r3(r3: dict, size: dict) -> None:
    if r3["bound"] != r3["pods"] or r3["over"] or r3["published"] != size["agents"] \
            or r3["sources"] != ["env"] or not r3["charged"]:
        raise AssertionError(f"run r3: bound {r3['bound']}/{r3['pods']}, over {r3['over']}, "
                             f"published {r3['published']}, sources {r3['sources']}, "
                             f"charged {len(r3['charged'])}")


def check_federation_run(run: dict, size: dict, card: bool) -> None:
    """One run (r)'s own gates, for the parts it ran; on the card every
    stack on ``cuda:0``, every part launched ``fleet_eval``, (r1)
    ``joint_fit`` and (r3) ``update_rows``, every launch equal to its
    plain version."""
    if "r1" in run:
        check_federation_r1(run["r1"], size)
    if "r2" in run:
        check_federation_r2(run["r2"], size, card)
    if "r3" in run:
        check_federation_r3(run["r3"], size)
    if not card:
        return
    need = {"r1": ("fleet_eval", "joint_fit"), "r2": ("fleet_eval",),
            "r3": ("fleet_eval", "update_rows")}
    for part, r in run.items():
        if r["devices"] != ["cuda:0"]:
            raise AssertionError(f"run {part}: stacks evaluated on {r['devices']}")
        k = r["kernels"]
        for name in need[part]:
            if k["launches"][name] <= 0:
                raise AssertionError(f"run {part}: {name} never launched")
        for name in ("fleet_eval", "joint_fit", "update_rows"):
            if k["kept"][name] != k["launches"][name] or k["max_abs_err"][name]:
                raise AssertionError(f"run {part} {name}: {k['kept'][name]} of "
                                     f"{k['launches'][name]} launches held, largest "
                                     f"difference {k['max_abs_err'][name]}")
        if part == "r1" and any(v["fleet_eval"] <= 0 for v in r["member_launches"].values()):
            raise AssertionError(f"run r1: a member launched nothing: {r['member_launches']}")


def check_federation(g: dict, c: dict, size: dict = FEDERATION_FULL) -> None:
    """Run (r) on the card against its CPU run."""
    check_federation_run(g, size, card=True)
    check_federation_run(c, size, card=False)
    for part, keys in (("r1", R1_PARITY), ("r3", R3_PARITY)):
        bad = [k for k in keys if g[part][k] != c[part][k]]
        if bad:
            raise AssertionError(f"run {part}: cuda != cpu in {bad}")


def print_federation(run: dict, smi: str) -> None:
    r1, r2, r3 = run.get("r1"), run.get("r2"), run.get("r3")
    if r1 is not None:
        print(f"run (r1) federation, {r1['nodes']} nodes: passes {r1['passes']}, "
              f"{r1['migrations']} migrated, kept home by the ledger {r1['ledger_kept']}, "
              f"rolled back {r1['victim']}; ladder "
              f"{[s['remote'] for s in r1['states']]}; spillover_pass ms "
              f"{[round(x, 3) for x in r1['spillover_ms']]}, health_pass ms median "
              f"{statistics.median(r1['health_ms']):.3f} (max {max(r1['health_ms']):.3f}); "
              f"migrated gang completion ms "
              f"{ {g: round(v, 1) for g, v in sorted(r1['completion_ms'].items())} }; "
              f"launches by member {json.dumps(r1['member_launches'])}; build "
              f"{r1['build_s']:.1f} s, run {r1['wall_s']:.1f} s | {smi}")
    if r2 is not None:
        print(f"run (r2) federated CLI: ready in {r2['start_to_ready_s']:.1f} s, remote boot "
              f"sync {r2['remote_sync_s']:.1f} s, {r2['bound']}/{r2['pods']} bound (p99 "
              f"{r2['p99_ms']} ms), states {r2['states']}, agent CR in "
              f"{r2['agent_cr_s']:.1f} s, v6e pod on {r2['agent_pod']}; members "
              f"{json.dumps(r2['members'])} | {smi}")
    if r3 is not None:
        print(f"run (r3) agents: {r3['published']} CRs ({r3['sources']}), run_once ms "
              f"{[round(x, 3) for x in r3['run_once_ms']]}, {len(r3['charged'])} charged, "
              f"{r3['bound']}/{r3['pods']} bound, pods/s "
              f"{[round(x, 1) for x in r3['pods_per_s'] if x]}, launches "
              f"{json.dumps(r3['member_launches'])} | {smi}")


def phase_federation(smi: str, rerun: "SpawnedRerun") -> dict:
    """Run (r) on the card; its CPU run is ``rerun``, spawned before run
    (m) beside run (q)'s."""
    g = run_federation("auto")
    print_federation(g, smi)
    c = rerun.result()
    print_federation(c, smi)
    check_federation(g, c)
    return g


# --- run (s): the degraded-mode dispatch chain --------------------------------

FALLBACK_FULL = dict(slices=512, v5e_hosts=2952, warm=8, singles=16, burst=16, gang=16,
                     pinned=64, numpy=16, timing_calls=20)
FALLBACK_SMALL = dict(slices=8, v5e_hosts=64, warm=8, singles=4, burst=8, gang=4,
                      pinned=8, numpy=4, timing_calls=2)
FALLBACK_PHASE = "fallback run (s)"  # the only phase that may demote a dispatch


class LevelTap:
    """A demoted level's kernel, wrapped for (s3): each evaluation's
    inputs (copied as they were: the resident dynamics row is maintained
    in place), the static rows that level held, its result and its wall ms
    are kept; everything else passes through."""

    def __init__(self, inner, level: int) -> None:
        self._inner, self.level, self.calls = inner, level, []

    def __getattr__(self, name: str):
        attr = getattr(self._inner, name)
        if not name.startswith("evaluate"):
            return attr

        def evaluate(*args):
            import copy

            kept = copy.deepcopy(args)
            t = time.perf_counter()
            out = attr(*args)
            ms = 1e3 * (time.perf_counter() - t)
            self.calls.append(dict(method=name, args=kept, static=self.static_rows(),
                                   names=list(self._inner.names), out=out, ms=ms))
            return out

        return evaluate

    def static_rows(self) -> tuple:
        """The [9, C, N] chip grids and [4, N] node rows this level holds,
        on the host: the plain version's own tensors (a re-put replaces
        them, nothing writes them), the numpy evaluator's live arrays
        copied."""
        from types import SimpleNamespace

        from yoda_tpu_torch.ops.kernel import stack_static

        inner = self._inner
        if self.level == 1:
            return inner._chips, inner._nodes
        chips, nodes = stack_static(SimpleNamespace(**inner._static))
        return torch.from_numpy(chips), torch.from_numpy(nodes)


def fleet_view(chips: torch.Tensor, nodes: torch.Tensor, names: list):
    """What ``put_static`` reads (the static fields by name, flags as bool)
    rebuilt from the device layout, so each level's kernel takes the rows
    a demoted call evaluated against."""
    from types import SimpleNamespace

    from yoda_tpu_torch.ops import kernel as kernel_mod

    fields = {k: chips[i].T.numpy() for i, k in enumerate(kernel_mod.CHIP_KEYS)}
    fields.update({k: nodes[i].numpy() for i, k in enumerate(kernel_mod.STATIC_NODE_KEYS)})
    for k in kernel_mod._BOOL_KEYS & fields.keys():
        fields[k] = fields[k] != 0
    return SimpleNamespace(names=names, **fields)


def result_rows(out) -> list:
    """A kernel entry point's result as a flat list of int arrays: every
    result row (feasible, reasons, raw, final, claimable, best), and for a
    fused plan the gangs' fits and picks."""
    from yoda_tpu_torch.ops.kernel import KernelResult

    if isinstance(out, KernelResult):
        return [out.feasible.astype(np.int32), out.reasons, out.raw_scores, out.scores,
                out.claimable, np.array([out.best_index])]
    if isinstance(out, tuple):
        grouped, fits, picks = out
        return (result_rows(grouped) + [np.array(fits, dtype=np.int32)]
                + [np.asarray(p) for p in picks])
    return [row for item in out for row in result_rows(item)]


def rows_err(got, want) -> int:
    """Largest difference of two result_rows lists (-1 when their shapes
    differ)."""
    a, b = result_rows(got), result_rows(want)
    if len(a) != len(b) or any(x.shape != y.shape for x, y in zip(a, b)):
        return -1
    return max((int(np.abs(x.astype(np.int64) - y).max()) for x, y in zip(a, b) if x.size),
               default=0)


def level_kernels(weights, view, device, levels=(0, 1, 2)) -> dict:
    """The chain's levels over ``view``'s rows: 0 the primary on ``device``
    (the hand kernels on the card), 1 the plain version on the host, 2 the
    numpy evaluator."""
    from yoda_tpu_torch.ops.kernel import NumpyFleetKernel, TorchFleetKernel

    make = {0: lambda: TorchFleetKernel(weights, device),
            1: lambda: TorchFleetKernel(weights, "cpu"), 2: lambda: NumpyFleetKernel(weights)}
    out = {level: make[level]() for level in levels}
    for kern in out.values():
        kern.put_static(view)
    return out


def install_plan_fault(batch, plan):
    """:func:`testing.chaos.install_chaos_kernel` with a wrapper whose fused
    plan (``evaluate_joint_plan``) draws from ``plan`` too: the port's
    ``ChaosKernel``, like the reference's, has no such method, so the fused
    plain-gang pass cannot be faulted through it."""
    from yoda_tpu_torch.testing.chaos import ChaosKernel

    class PlanFault(ChaosKernel):
        def evaluate_joint_plan(self, dyn, host_ok_groups, request_groups, minimum=1):
            self._maybe_fail("plan")
            return self._inner.evaluate_joint_plan(dyn, host_ok_groups, request_groups,
                                                   minimum)

    inner = batch._kern
    batch._kern = PlanFault(inner, plan)
    if batch._resident is not None and batch._resident.kern is inner:
        batch._resident.kern = batch._kern
    return batch._kern


def uninstall_fault(batch, wrapped) -> None:
    """Put the primary back where a fault wrapper took its place."""
    batch._kern = wrapped._inner
    if batch._resident is not None and batch._resident.kern is wrapped:
        batch._resident.kern = wrapped._inner


def fallback_gangs(prefix: str, size: dict, count: int = 2) -> list:
    """``count`` plain gangs of ``size["gang"]`` v5e members x 8 chips: a
    joint pass of them runs the fused plan."""
    return [(f"{prefix}{g}-{i:02d}", {"tpu/gang": f"{prefix}{g}",
                                       "tpu/gang-size": str(size["gang"]),
                                       "tpu/chips": "8", "tpu/generation": "v5e"})
            for g in range(count) for i in range(size["gang"])]


def run_fallback(size: dict = FALLBACK_FULL, *, hold_on: "str | None" = None,
                 reported: bool = True) -> dict:
    """Run (s)'s chain half, the degraded-mode dispatch chain on stacks
    whose primary is on the host (``kernel_platform: cpu``: the only
    primary the port demotes) over the 5,000-node fleet at default
    settings, with faults injected through the port's ``testing.chaos``;
    every demoted call is kept (:class:`LevelTap`):
    (s1) one-shot faults, each installed alone and then removed: 16 run (a)
    singletons at ``batch_requests`` 1 (one stack), a K = 16 burst of run
    (b)'s pods and a joint pass of two plain gangs of 16 x 8 v5e chips (the
    fused plan, faulted by :func:`install_plan_fault`) at
    ``batch_requests`` 16 (a second stack, warmed the same way): each fault
    served at level 1 in its cycle, the pin back at 0, and the primary
    serving again after it (a singleton; a joint pass of two more gangs);
    (s2) a persistent fault (``count`` 100) on the second stack: three
    singletons one at a time pin level 1, the plan's invocations stop,
    ``/metrics`` shows the pin, 64 singletons bind at level 1; then level
    1 wrapped in a ``ChaosKernel`` too: 16 singletons one at a time (the
    third failure pins level 2) and two plain gangs bind at level 2;
    (s3, with ``hold_on`` a card platform) each kept call again on the
    hand kernels on the same inputs (all six rows, picks and fits;
    tolerance 0), and, reported, ms per call of levels 0, 1 and 2 on a
    K = 1 and a K = 16 input of the run.
    The pool bound a level-1 kernel sets on torch's threads is lifted when
    the run ends."""
    from yoda_tpu_torch.api.types import PodSpec
    from yoda_tpu_torch.testing.chaos import (
        ChaosKernel,
        ChaosPlan,
        FaultSpec,
        install_chaos_kernel,
    )

    threads = torch.get_num_threads()
    pods_a, pods_b = fleet_and_pods(seed=0)
    steps: list = []
    bindings: dict = {}
    taps: list = []

    def drain(stack, pods, one_at_a_time: bool = False) -> None:
        for group in ([[p] for p in pods] if one_at_a_time else [pods]):
            for name, labels in group:
                stack.cluster.create_pod(PodSpec(name, labels=dict(labels)))
            stack.scheduler.run_until_idle(max_wall_s=600)
        bindings.update(bindings_of(stack, [n for n, _ in pods]))

    def step(stack, what: str, plan=None) -> dict:
        b = stack.batch
        row = dict(step=what, **dispatch_health(b),
                   probes=plan.invocations("dispatch") if plan is not None else None,
                   level1_calls=len(b._fb_kerns[1].calls)
                   if isinstance(b._fb_kerns.get(1), LevelTap) else None)
        steps.append(row)
        return row

    def warmed(burst: int, warm: list):
        stack, _agent = build_fleet("cpu", burst, slices=size["slices"],
                                    v5e_hosts=size["v5e_hosts"])
        drain(stack, warm)
        b = stack.batch
        for level in (1, 2):  # built as the chain builds them, then tapped
            b._kernel_at(level, b._static)
            b._fb_kerns[level] = LevelTap(b._fb_kerns[level], level)
            taps.append(b._fb_kerns[level])
        return stack

    wall0 = time.monotonic()
    w, n1 = size["warm"], size["singles"]
    one = warmed(1, pods_a[:w])
    step(one, "warm K=1")
    oneshot = ChaosPlan([FaultSpec("dispatch", 0, "error")])
    wrapped = install_chaos_kernel(one.batch, oneshot)
    drain(one, pods_a[w : w + n1])
    step(one, "s1 singletons", oneshot)
    uninstall_fault(one.batch, wrapped)
    over = over_capacity(one)
    close_stack(one)

    burst = warmed(16, pods_a[w + n1 : 2 * w + n1])
    b = burst.batch
    step(burst, "warm K=16")
    at = size["burst"]
    # After each fault is removed the primary serves again (a singleton, a
    # joint pass): the pin is back at 0 and the level's consecutive
    # failures reset.
    oneshot = ChaosPlan([FaultSpec("dispatch", 0, "error")])
    wrapped = install_chaos_kernel(b, oneshot)
    drain(burst, pods_b[:at])
    step(burst, "s1 burst", oneshot)
    uninstall_fault(b, wrapped)
    drain(burst, pods_b[at : at + 1])
    step(burst, "s1 burst, then the primary")
    oneshot = ChaosPlan([FaultSpec("dispatch", 0, "error")])
    wrapped = install_plan_fault(b, oneshot)
    drain(burst, fallback_gangs("s1-plain", size))
    step(burst, "s1 fused plan", oneshot)
    uninstall_fault(b, wrapped)
    drain(burst, fallback_gangs("s1-clean", size))  # the fused plan at level 0
    step(burst, "s1 fused plan, then the primary")

    at += 1
    persistent = ChaosPlan([FaultSpec("dispatch", 0, "error", count=100)])
    install_chaos_kernel(b, persistent)
    drain(burst, pods_b[at : at + 3], one_at_a_time=True)
    step(burst, "s2 pin level 1", persistent)
    at += 3
    pinned_metrics = {k: v for k, v in scrape_values(
        burst.metrics.registry.render_prometheus()).items()
        if k.startswith(("yoda_dispatch_backend_level", "yoda_dispatch_fallback_total"))}
    drain(burst, pods_b[at : at + size["pinned"]])
    step(burst, "s2 pinned", persistent)
    at += size["pinned"]
    level1 = ChaosPlan([FaultSpec("dispatch", 0, "error", count=100)])
    b._fb_kerns[1] = ChaosKernel(b._fb_kerns[1], level1)
    drain(burst, pods_b[at : at + size["numpy"]], one_at_a_time=True)
    step(burst, "s2 level 2 singletons", level1)
    drain(burst, fallback_gangs("s2-plain", size))
    step(burst, "s2 level 2 fused plan", level1)
    over += over_capacity(burst)
    fused = b.fused_plan_dispatches
    close_stack(burst)
    wall = time.monotonic() - wall0
    calls = [c for tap in taps for c in tap.calls]
    out = dict(
        platform="cpu", steps=steps, bindings=bindings, pinned_metrics=pinned_metrics,
        tapped=[(c["method"], len(c["args"][2]) if c["method"] == "evaluate_burst" else None)
                for c in calls],
        levels=[tap.level for tap in taps for _ in tap.calls],
        over=over, fused_plan_dispatches=fused, wall_s=wall,
    )
    if hold_on is not None:
        out["s3"] = hold_demoted(calls, taps[0].weights, hold_on, size, reported=reported)
    torch.set_num_threads(threads)
    return out


def hold_demoted(calls: list, weights, platform: str, size: dict, *,
                 reported: bool) -> dict:
    """(s3): each demoted call again on the card's hand kernels on its own
    inputs and rows, every result row, fit and pick compared; reported,
    ms per call of each level on a K = 1 and a K = 16 input of the run
    (median of ``timing_calls``; level 0 is the round trip through
    ``fleet_eval``)."""
    from yoda_tpu_torch.ops.kernel import resolve_device

    device = resolve_device(platform)
    err, compared = 0, 0
    for c in calls:
        kern = level_kernels(weights, fleet_view(*c["static"], c["names"]), device, (0,))[0]
        got = getattr(kern, c["method"])(*c["args"])
        e = rows_err(c["out"], got)
        err = e if e < 0 or err < 0 else max(err, e)
        compared += 1
    out = dict(compared=compared, max_abs_err=err)
    if not reported:
        return out
    timing = {}
    for k in (1, 16):
        c = next(c for c in calls if c["method"] == "evaluate_burst" and len(c["args"][2]) == k
                 or k == 1 and c["method"] == "evaluate")
        dyn, *rest = c["args"]
        if c["method"] == "evaluate":
            rest = [np.asarray(dyn)[3:4], [rest[0]]]
        kerns = level_kernels(weights, fleet_view(*c["static"], c["names"]), device)
        row = {}
        for level, kern in kerns.items():
            ms = []
            for _ in range(size["timing_calls"]):
                t = time.perf_counter()
                kern.evaluate_burst(dyn, *rest)
                ms.append(1e3 * (time.perf_counter() - t))
            row[f"level{level}_ms"] = statistics.median(ms)
        timing[f"k{k}"] = row
    out["timing"] = timing
    return out


def check_fallback_run(run: dict, size: dict) -> None:
    """The chain half's gates: each one-shot fault served at level 1 in its
    cycle (one more fallback, one more level-1 call) with the pin back at
    0; the persistent fault pins level 1 after three failures and the
    plan's invocations stop there; ``/metrics`` shows the pin and the
    fallbacks; level 2 pinned after three failures at level 1; every pod
    bound, no host over its chips; with (s3), every demoted call equal to
    the hand kernels on its inputs."""
    s = {row["step"]: row for row in run["steps"]}
    bad = []
    for part in ("s1 singletons", "s1 burst", "s1 fused plan"):
        r = s[part]
        if r["probes"] < 1 or r["backend_level"] != 0:
            bad.append(f"{part}: {r}")
    pairs = (("warm K=1", "s1 singletons"), ("warm K=16", "s1 burst"),
             ("s1 burst", "s1 burst, then the primary"),
             ("s1 burst, then the primary", "s1 fused plan"),
             ("s1 fused plan", "s1 fused plan, then the primary"))
    falls = [s[b]["dispatch_fallbacks"] - s[a]["dispatch_fallbacks"] for a, b in pairs]
    calls = [s[b]["level1_calls"] - s[a]["level1_calls"] for a, b in pairs]
    if falls != [1, 1, 0, 1, 0] or calls != [1, 1, 0, 1, 0]:
        bad.append(f"one-shot faults: fallbacks {falls}, level-1 calls {calls}")
    for part in ("s1 burst, then the primary", "s1 fused plan, then the primary"):
        if s[part]["backend_level"] != 0:
            bad.append(f"{part}: {s[part]}")
    pin, pinned = s["s2 pin level 1"], s["s2 pinned"]
    if pin["backend_level"] != 1 or pin["dispatch_errors"] - s["s1 fused plan"][
            "dispatch_errors"] != 3 or pin["probes"] != 3:
        bad.append(f"pin: {pin}")
    if pinned["probes"] != pin["probes"] or pinned["backend_level"] != 1 \
            or pinned["dispatch_errors"] != pin["dispatch_errors"]:
        bad.append(f"pinned: {pinned}")
    m = run["pinned_metrics"]
    if m.get("yoda_dispatch_backend_level") != 1.0 or not m.get("yoda_dispatch_fallback_total"):
        bad.append(f"/metrics at the pin: {m}")
    low, gang = s["s2 level 2 singletons"], s["s2 level 2 fused plan"]
    if low["backend_level"] != 2 or low["probes"] != 3 or gang["backend_level"] != 2:
        bad.append(f"level 2: {low}, {gang}")
    if 2 not in run["levels"]:
        bad.append("no call served at level 2")
    unbound = sorted(n for n, v in run["bindings"].items() if v is None)
    if unbound or run["over"]:
        bad.append(f"unbound {unbound[:6]}, over {run['over'][:4]}")
    s3 = run.get("s3")
    if s3 is not None and (s3["compared"] != len(run["tapped"]) or s3["max_abs_err"] != 0):
        bad.append(f"(s3): {s3['compared']} of {len(run['tapped'])} demoted calls "
                   f"compared, largest difference {s3['max_abs_err']}")
    if bad:
        raise AssertionError("run (s): " + "; ".join(bad))


def run_card_faults(platform: str, size: dict = FALLBACK_FULL) -> dict:
    """Run (s)'s card half, (s4): (s1)'s and (s2)'s faults on stacks whose
    primary is on the card, which the port never demotes. Each injected
    fault is counted in ``dispatch_errors`` and re-raised, its pod's cycle
    ends in error, the pod binds on the card when it is retried, and no
    host level is built. One-shot faults, each installed alone and then
    removed: 16 run (a) singletons at ``batch_requests`` 1, a K = 16 burst
    of run (b)'s pods and a joint pass of two plain gangs of 16 x 8 v5e
    chips (the fused plan) at ``batch_requests`` 16, each stack after 8
    warm-up singletons; then a persistent fault over three singletons one
    at a time (each retry probes the card again: no pin), ``/metrics``
    read, the fault removed and the pods retried."""
    from yoda_tpu_torch.api.types import PodSpec
    from yoda_tpu_torch.testing.chaos import ChaosPlan, FaultSpec, install_chaos_kernel

    pods_a, pods_b = fleet_and_pods(seed=0)
    steps: list = []
    bindings: dict = {}
    over: list = []
    created: dict = {}  # id(stack) -> the names of the pods made there

    def drain(stack, pods, one_at_a_time: bool = False) -> None:
        for group in ([[p] for p in pods] if one_at_a_time else [pods]):
            for name, labels in group:
                stack.cluster.create_pod(PodSpec(name, labels=dict(labels)))
            stack.scheduler.run_until_idle(max_wall_s=600)
        created.setdefault(id(stack), []).extend(n for n, _ in pods)

    def retry(stack) -> None:
        stack.scheduler.queue.move_all_to_active(force=True)
        stack.scheduler.run_until_idle(max_wall_s=600)

    def step(stack, what: str, plan=None) -> None:
        b = stack.batch
        steps.append(dict(
            step=what, **dispatch_health(b),
            faults=len(plan.fired) if plan is not None else None,
            cycle_errors=sum(r.outcome == "error" for r in stack.scheduler.stats.results),
            host_levels=len(b._fb_kerns)))

    def warmed(burst: int, warm: list):
        stack, _agent = build_fleet(platform, burst, slices=size["slices"],
                                    v5e_hosts=size["v5e_hosts"])
        drain(stack, warm)
        return stack

    def closed(stack) -> None:
        bindings.update(bindings_of(stack, created[id(stack)]))
        over.extend(over_capacity(stack))
        close_stack(stack)

    def oneshot(stack, pods, what: str, install=install_chaos_kernel) -> None:
        plan = ChaosPlan([FaultSpec("dispatch", 0, "error")])
        wrapped = install(stack.batch, plan)
        drain(stack, pods)
        uninstall_fault(stack.batch, wrapped)
        retry(stack)
        step(stack, what, plan)

    kept = KeptKernels()
    kept.install()
    wall0 = time.monotonic()
    try:
        w, n1 = size["warm"], size["singles"]
        one = warmed(1, pods_a[:w])
        step(one, "warm K=1")
        oneshot(one, pods_a[w : w + n1], "s4 singletons")
        closed(one)

        burst = warmed(16, pods_a[w + n1 : 2 * w + n1])
        step(burst, "warm K=16")
        at = size["burst"]
        oneshot(burst, pods_b[:at], "s4 burst")
        oneshot(burst, fallback_gangs("s4-plain", size), "s4 fused plan", install_plan_fault)
        drain(burst, fallback_gangs("s4-clean", size))  # the fused plan on the card
        step(burst, "s4 fused plan, then the card")
        persistent = ChaosPlan([FaultSpec("dispatch", 0, "error", count=100)])
        wrapped = install_chaos_kernel(burst.batch, persistent)
        drain(burst, pods_b[at : at + 3], one_at_a_time=True)
        step(burst, "s4 persistent", persistent)
        metrics = {k: v for k, v in scrape_values(
            burst.metrics.registry.render_prometheus()).items()
            if k.startswith("yoda_dispatch_")}
        uninstall_fault(burst.batch, wrapped)
        retry(burst)
        step(burst, "s4 after the fault")
        fused = burst.batch.fused_plan_dispatches
        closed(burst)
    finally:
        kept.restore()
    return dict(platform=platform, steps=steps, bindings=bindings, metrics=metrics,
                over=over, fused_plan_dispatches=fused, wall_s=time.monotonic() - wall0,
                **kept.errors())


def check_card_faults(run: dict) -> None:
    """(s4)'s gates: every fault that fired counted once in
    ``dispatch_errors`` and nothing else counted; the one-shot fault at
    K = 1 ends its pod's cycle in error, the one-shot faults in a K = 16
    burst's and a joint pass's pre-evaluation end none (their pods are
    evaluated one by one on the card, as for any failed pre-evaluation);
    the persistent fault fires at every dispatch, three or more, and ends
    three or more cycles in error; nothing demoted, no pin, no host level
    built; ``/metrics`` shows the errors, level 0 and no fallback; the fused
    plan runs on the card after the faults; every pod bound on the card
    after its retry, no host over its chips, every launch equal to its
    plain version and, on the card, both kernels launched."""
    s = {row["step"]: row for row in run["steps"]}
    bad = []
    for a, b, cycles in (("warm K=1", "s4 singletons", (1, 1)),
                         ("warm K=16", "s4 burst", (0, 0)),
                         ("s4 burst", "s4 fused plan", (0, 0)),
                         ("s4 fused plan", "s4 persistent", (3, 1 << 30))):
        errors = s[b]["dispatch_errors"] - s[a]["dispatch_errors"]
        ended = s[b]["cycle_errors"] - s[a]["cycle_errors"]
        fired = s[b]["faults"]
        if errors != fired or not (fired == 1 or b == "s4 persistent" and fired >= 3) \
                or not cycles[0] <= ended <= min(cycles[1], errors):
            bad.append(f"{b}: {fired} faults fired, {errors} dispatch errors, "
                       f"{ended} cycles ended in error")
    if any(r["dispatch_fallbacks"] or r["backend_level"] or r["host_levels"]
           for r in run["steps"]):
        bad.append(f"demoted: {run['steps']}")
    last = s["s4 after the fault"]
    m = run["metrics"]
    if (m.get("yoda_dispatch_backend_level") != 0.0 or m.get("yoda_dispatch_fallback_total")
            or m.get("yoda_dispatch_errors_total") != s["s4 persistent"]["dispatch_errors"]):
        bad.append(f"/metrics under the persistent fault: {m}")
    if last["dispatch_errors"] != s["s4 persistent"]["dispatch_errors"]:
        bad.append("a dispatch failed after the faults were removed")
    if s["s4 fused plan, then the card"]["dispatch_errors"] != s["s4 fused plan"][
            "dispatch_errors"] or not run["fused_plan_dispatches"]:
        bad.append(f"the fused plan after the faults: {run['fused_plan_dispatches']} dispatches")
    unbound = sorted(n for n, v in run["bindings"].items() if v is None)
    if unbound or run["over"]:
        bad.append(f"unbound {unbound[:6]}, over {run['over'][:4]}")
    if run["kept"] != run["launches"] or any(run["max_abs_err"].values()):
        bad.append(f"launches against the plain versions: {run['kept']} of "
                   f"{run['launches']}, {run['max_abs_err']}")
    if run["platform"] != "cpu" and not (run["launches"]["fleet_eval"]
                                         and run["launches"]["joint_fit"]):
        bad.append(f"the card launched {run['launches']}")
    if bad:
        raise AssertionError("run (s4): " + "; ".join(bad))


def print_fallback(chain: dict, card: dict, smi: str) -> None:
    print(f"run (s) fallback chain (host primary): {len(chain['bindings'])} pods bound "
          f"in {chain['wall_s']:.1f} s; steps "
          + json.dumps([{k: r[k] for k in ("step", "dispatch_errors", "dispatch_fallbacks",
                                           "backend_level", "probes")} for r in chain["steps"]])
          + f"; pin on /metrics {chain['pinned_metrics']}; demoted calls "
          f"{len(chain['tapped'])} (levels {sorted(set(chain['levels']))}); "
          f"s3 {json.dumps(chain.get('s3'))} | {smi}", flush=True)
    print(f"run (s4) faults on the card: {len(card['bindings'])} pods bound in "
          f"{card['wall_s']:.1f} s; steps "
          + json.dumps([{k: r[k] for k in ("step", "dispatch_errors", "cycle_errors",
                                           "dispatch_fallbacks", "backend_level", "faults")}
                        for r in card["steps"]])
          + f"; /metrics {card['metrics']}; launches {card['launches']} | {smi}", flush=True)


def phase_fallback(smi: str) -> dict:
    """Run (s), last (the chain half's level-1 kernels bound torch's pool
    for the process; the run lifts it again): (s4) the faults on card
    stacks, then the chain on host-primary stacks with (s3) on the card."""
    g = run_card_faults("auto")
    check_card_faults(g)
    c = run_fallback(FALLBACK_FULL, hold_on="auto")
    print_fallback(c, g, smi)
    check_fallback_run(c, FALLBACK_FULL)
    g["s3"] = c["s3"]
    return g


def main() -> None:
    if sys.argv[1:2] == ["--spec-worker"]:
        sys.exit(spec_worker_entry(sys.argv[2:]))
    # One string hash seed for this process and the CPU reruns it spawns:
    # a gang's Permit waiters are released in set order, so the order of
    # the uids in run (o)'s journal commit records follows the hash seed
    # (the bindings do not). Re-executed once with the seed pinned.
    if os.environ.get("PYTHONHASHSEED") != "0":
        os.environ["PYTHONHASHSEED"] = "0"
        os.execv(sys.executable, [sys.executable, *sys.argv])
    if not torch.cuda.is_available():
        print("no CUDA device: chip_smoke.py needs one NVIDIA GPU", file=sys.stderr)
        sys.exit(2)
    seconds: dict[str, float] = {}
    watch = None  # every dispatch in this process, from the build on

    def phase(label: str, fn, *args):
        t = time.monotonic()
        try:
            out = fn(*args)
            if watch is not None and label != FALLBACK_PHASE:
                watch.check(label)
        except Exception as e:  # noqa: BLE001 — report the failing phase
            fail(label, e)
        seconds[label] = time.monotonic() - t
        print(f"phase {label}: {seconds[label]:.1f} s", flush=True)
        return out

    kind, smi = phase("device/build", phase_device)
    watch = DispatchWatch().install()
    rerun = CpuRerun(BACKGROUND_FULL, NODEHEALTH_FULL)
    obs_rerun = SpawnedRerun("run_observability", OBSERVABILITY_FULL, "run (j)")
    tenancy_rerun = SpawnedRerun("run_tenancy", TENANCY_FULL, "run (k)")
    pipeline_rerun = SpawnedRerun("run_pipeline", PIPELINE_FULL, "run (l3)")
    lanes_rerun = SpawnedRerun("run_lanes", LANES_FULL, "run (o)")
    chaos_rerun = fed_rerun = None
    try:
        rows, profiled = phase("kernel vs plain", phase_kernel)
        joint_rows = phase("joint_fit vs plain", phase_joint_fit)
        update_rows = phase("update_rows vs put_static", phase_update_rows)
        gpu = phase("main path", phase_main_path, smi)
        gangs = phase("gang path", phase_gang_path, smi)
        churn = phase("churn run (e)", phase_churn, smi)
        preemption = phase("preemption run (f)", phase_preemption, smi)
        affinity = phase("affinity run (g)", phase_affinity, smi)
        wide = phase("wide fleet", phase_wide_fleet, smi)
        background = phase("background run (h)", phase_background, smi, rerun)
        nodehealth = phase("node health run (i)", phase_nodehealth, smi, rerun)
        observability = phase("observability run (j)", phase_observability, smi, obs_rerun)
        tenancy = phase("tenancy run (k)", phase_tenancy, smi, tenancy_rerun)
        process = phase("process run (l)", phase_process, smi, pipeline_rerun,
                        seconds["device/build"])
        chaos_rerun = SpawnedRerun("run_chaos", CHAOS_FULL, "run (q)")
        fed_rerun = SpawnedRerun("run_federation", FEDERATION_FULL, "run (r)", daemon=False)
        loop = phase("loop run (m)", phase_loop, smi)
        sharded = phase("sharded run (n)", phase_sharded, smi, gpu)
        lanes = phase("lanes run (o)", phase_lanes, smi, lanes_rerun)
        proc = phase("process lanes run (p)", phase_proc, smi, lanes)
        chaos = phase("chaos run (q)", phase_chaos, smi, chaos_rerun)
        federation = phase("federation run (r)", phase_federation, smi, fed_rerun)
        fallback = phase(FALLBACK_PHASE, phase_fallback, smi)
        print("phase seconds:", json.dumps(seconds))
        q_parts = ("q1", "q2", "q3")
        r_parts = ("r1", "r2", "r3")

        def r_launches(name: str) -> dict:
            return {p: federation[p]["kernels"]["launches"][name] for p in r_parts}

        def r_by_member(name: str) -> dict:
            return {p: {member: n[name] for member, n in federation[p][
                "members" if p == "r2" else "member_launches"].items()} for p in r_parts}

        def r_err(name: str) -> list:
            return [federation[p]["kernels"]["max_abs_err"][name] for p in r_parts]
        o_parts = tuple(p for p in ("o1", "o3", "o4") + O2_PARTS if p in lanes)
        l_parts = ("l1", "l2", "l3", "l4")
        j_parts = ("j1", "j1_wall", "j2", "j3", "cost")
        k_parts = ("k1", "k1_unfair", "k2", "k3")
        h_runs = [background[part] for part in ("h1", "h2", "h3", "h4", "h4_nospec")]
        main_row = next(
            r for r in profiled
            if (r["nodes"], r["padded"], r["k"]) == MAIN_PATH_SHAPE and r["chips"] == CHIPS
        )
        joint_main = next(
            r for r in joint_rows
            if r["case"] == "seeded" and (r["k"], r["n"]) == JOINT_MAIN_SHAPE
        )
        update_main = next(
            r for r in update_rows if (r["padded"], r["rows"]) == UPDATE_MAIN_SHAPE
        )
        kernels = {
            "kernels": [
                {
                    "name": "fleet_eval",
                    "route": "cuda",
                    "source": "yoda_tpu_torch/csrc/fleet_eval.cu",
                    "replaces": (
                        "yoda_tpu/ops/pallas_kernel.py:268 (_pallas_eval) + "
                        "yoda_tpu/ops/pallas_kernel.py:299 (_pallas_eval_burst)"
                    ),
                    "launches": sum(run["launches"] for run in (
                        gpu["a"], gpu["b"], gangs["c"], gangs["d"], churn, preemption,
                        affinity, *wide, *h_runs, nodehealth))
                    + sum(observability[p]["launches"]["fleet_eval"] for p in j_parts)
                    + sum(tenancy[p]["launches"]["fleet_eval"] for p in k_parts)
                    + sum(process[p]["launches"]["fleet_eval"] for p in l_parts)
                    + loop["m1"]["launches"]
                    + sum(lanes[p]["kernels"]["launches"]["fleet_eval"] for p in o_parts)
                    + sum(w["launches"]["fleet_eval"] for w in proc["p1"]["kernels"].values())
                    + sum(chaos[p]["kernels"]["launches"]["fleet_eval"] for p in q_parts)
                    + sum(r_launches("fleet_eval").values())
                    + fallback["launches"]["fleet_eval"],
                    "launches_run_s": fallback["launches"]["fleet_eval"],
                    "run_s_demoted_calls": fallback["s3"]["compared"],
                    "run_s_demoted_vs_kernel_max_abs_err": fallback["s3"]["max_abs_err"],
                    "run_s_ms_per_dispatch_by_level": fallback["s3"]["timing"],
                    "launches_run_r": r_launches("fleet_eval"),
                    "launches_run_r_by_member": r_by_member("fleet_eval"),
                    "launches_run_p1_by_worker": {
                        lane: w["launches"]["fleet_eval"]
                        for lane, w in proc["p1"]["kernels"].items()
                    },
                    "launches_run_q": {
                        p: chaos[p]["kernels"]["launches"]["fleet_eval"] for p in q_parts
                    },
                    "launches_run_o": {
                        p: lanes[p]["kernels"]["launches"]["fleet_eval"] for p in o_parts
                    },
                    "launches_run_o_by_lane": {
                        p: {lane: n["fleet_eval"] for lane, n in lanes[p]["lane_launches"].items()}
                        for p in o_parts
                    },
                    "launches_run_g": affinity["launches"],
                    "launches_run_m1": loop["m1"]["launches"],
                    "launches_run_l": {
                        p: process[p]["launches"]["fleet_eval"] for p in l_parts
                    },
                    "launches_run_j": {
                        p: observability[p]["launches"]["fleet_eval"] for p in j_parts
                    },
                    "launches_run_k": {
                        p: tenancy[p]["launches"]["fleet_eval"] for p in k_parts
                    },
                    "launches_run_i": {
                        part: n["fleet_eval"] for part, n in nodehealth["phase_launches"].items()
                    },
                    "run_g_k1_device_ms": not_measured(affinity["fleet_eval_k1_device_ms"]),
                    "run_g_k1_ms": not_measured(affinity["fleet_eval_k1_ms"]),
                    "run_g_k1_plain_ms": not_measured(affinity["fleet_eval_k1_plain_ms"]),
                    "launches_run_h": {
                        part: background[part]["launches"]
                        for part in ("h1", "h2", "h3", "h4", "h4_nospec")
                    },
                    "launches_run_h_speculation": {
                        "h1": background["h1"]["spec_launches"],
                        "h4": background["h4"]["spec_launches"],
                    },
                    "run_h_spec_k1_device_ms": not_measured(
                        background["h1"]["concurrent"]["alone_device_ms"]),
                    "run_h_concurrent_k1_ms": {
                        k: not_measured(v) for k, v in background["h1"]["concurrent"].items()
                    },
                    "max_abs_err": max(max(r["max_abs_err"] for r in rows),
                                       nodehealth["max_abs_err"]["fleet_eval"],
                                       *(observability[p]["max_abs_err"]["fleet_eval"]
                                         for p in j_parts),
                                       *(tenancy[p]["max_abs_err"]["fleet_eval"]
                                         for p in k_parts),
                                       *(process[p]["max_abs_err"]["fleet_eval"]
                                         for p in l_parts),
                                       *(lanes[p]["kernels"]["max_abs_err"]["fleet_eval"]
                                         for p in o_parts),
                                       *(w["max_abs_err"]["fleet_eval"]
                                         for w in proc["p1"]["kernels"].values()),
                                       *(chaos[p]["kernels"]["max_abs_err"]["fleet_eval"]
                                         for p in q_parts),
                                       *r_err("fleet_eval"),
                                       fallback["max_abs_err"]["fleet_eval"]),
                    "ms": main_row["ms"],
                    "plain_ms": main_row["plain_ms"],
                    "bound_ms": main_row["bound_ms"],
                    "bound_by": main_row["bound_by"],
                    "library_ms": None,
                    "device_ms": not_measured(main_row["device_ms"]),
                    "round_trip_ms": main_row["round_trip_ms"],
                    "cuda_launches_per_call": not_measured(main_row["launches_per_call"]),
                    "shapes": [
                        {
                            key: not_measured(r.get(key))
                            for key in ("padded", "chips", "k", "ms", "device_ms",
                                        "launches_per_call", "plain_ms", "bound_ms",
                                        "bound_by", "plan", "round_trips_ms", "smi")
                        }
                        for r in profiled
                    ],
                },
                {
                    "name": "joint_fit",
                    "route": "cuda",
                    "source": "yoda_tpu_torch/csrc/joint_fit.cu",
                    "replaces": (
                        "yoda_tpu/ops/kernel.py:500 joint_fit_scan "
                        "(lax.scan in kernel_joint_plan, :581)"
                    ),
                    "launches": gangs["c"]["joint_fit_launches"]
                    + gangs["d"]["joint_fit_launches"] + preemption["joint_fit_launches"]
                    + affinity["joint_fit_launches"]
                    + sum(run["joint_fit_launches"] for run in h_runs[1:])
                    + nodehealth["joint_fit_launches"]
                    + sum(observability[p]["launches"]["joint_fit"] for p in j_parts)
                    + sum(tenancy[p]["launches"]["joint_fit"] for p in k_parts)
                    + sum(process[p]["launches"]["joint_fit"] for p in l_parts)
                    + sum(lanes[p]["kernels"]["launches"]["joint_fit"] for p in o_parts)
                    + sum(w["launches"]["joint_fit"] for w in proc["p1"]["kernels"].values())
                    + sum(chaos[p]["kernels"]["launches"]["joint_fit"] for p in q_parts)
                    + sum(r_launches("joint_fit").values())
                    + fallback["launches"]["joint_fit"],
                    "launches_run_s": fallback["launches"]["joint_fit"],
                    "launches_run_r": r_launches("joint_fit"),
                    "launches_run_r_by_member": r_by_member("joint_fit"),
                    "launches_run_p1_by_worker": {
                        lane: w["launches"]["joint_fit"]
                        for lane, w in proc["p1"]["kernels"].items()
                    },
                    "launches_run_q": {
                        p: chaos[p]["kernels"]["launches"]["joint_fit"] for p in q_parts
                    },
                    "launches_run_l": {
                        p: process[p]["launches"]["joint_fit"] for p in l_parts
                    },
                    "launches_run_o": {
                        p: lanes[p]["kernels"]["launches"]["joint_fit"] for p in o_parts
                    },
                    "launches_run_o_by_lane": {
                        p: {lane: n["joint_fit"] for lane, n in lanes[p]["lane_launches"].items()}
                        for p in o_parts
                    },
                    "launches_run_i": {
                        part: n["joint_fit"] for part, n in nodehealth["phase_launches"].items()
                    },
                    "launches_run_j": {
                        p: observability[p]["launches"]["joint_fit"] for p in j_parts
                    },
                    "launches_run_k": {
                        p: tenancy[p]["launches"]["joint_fit"] for p in k_parts
                    },
                    "max_abs_err": max(max(r["max_abs_err"] for r in joint_rows),
                                       nodehealth["max_abs_err"]["joint_fit"],
                                       *(observability[p]["max_abs_err"]["joint_fit"]
                                         for p in j_parts),
                                       *(tenancy[p]["max_abs_err"]["joint_fit"]
                                         for p in k_parts),
                                       *(process[p]["max_abs_err"]["joint_fit"]
                                         for p in l_parts),
                                       *(lanes[p]["kernels"]["max_abs_err"]["joint_fit"]
                                         for p in o_parts),
                                       *(w["max_abs_err"]["joint_fit"]
                                         for w in proc["p1"]["kernels"].values()),
                                       *(chaos[p]["kernels"]["max_abs_err"]["joint_fit"]
                                         for p in q_parts),
                                       *r_err("joint_fit"),
                                       fallback["max_abs_err"]["joint_fit"]),
                    "ms": joint_main["ms"],
                    "device_ms": not_measured(joint_main["device_ms"]),
                    "plain_ms": joint_main["plain_ms"],
                    "bound_ms": joint_main["bound_ms"],
                    "bound_by": "bytes",
                    "library_ms": None,
                    "main_path_device_ms": {
                        run: not_measured(gangs[run]["joint_fit_device_ms"])
                        for run in ("c", "d")
                    },
                    "shapes": [
                        {
                            key: not_measured(r.get(key))
                            for key in ("case", "k", "n", "ms", "device_ms", "us_per_row",
                                        "plain_ms", "bound_ms", "plan", "smi")
                        }
                        for r in joint_rows
                    ],
                },
                {
                    "name": "fleet_eval_shard",
                    "route": "cuda",
                    "source": "yoda_tpu_torch/csrc/fleet_eval.cu (fleet_eval_shard_launch)",
                    "replaces": (
                        "yoda_tpu/parallel/sharded.py:94 (ShardedFleetKernel) + "
                        ":146 / :155 (ShardedDeviceFleetKernel): kernel_impl under "
                        "row-sharded NamedSharding"
                    ),
                    "launches": sharded["n2"]["shard_launches"],
                    "launches_run_n": {
                        "n1": sum(r["launches_per_call"] for r in sharded["rows"]),
                        "n2": sharded["n2"]["shard_launches"],
                    },
                    "max_abs_err": max(max(r["max_abs_err"] for r in sharded["rows"]),
                                       sharded["n2"]["max_abs_err"]),
                    "ms": sharded["main"]["ms"],
                    "plain_ms": sharded["main"]["plain_ms"],
                    "bound_ms": sharded["main"]["bound_ms"],
                    "bound_by": sharded["main"]["bound_by"],
                    "library_ms": None,
                    "device_ms": not_measured(sharded["main"]["device_ms"]),
                    "device_ms_per_phase": not_measured(sharded["main"]["phase_ms"]),
                    "combine_device_ms": not_measured(sharded["main"]["combine_ms"]),
                    "cuda_launches_per_call": sharded["main"]["launches_per_call"],
                    "shapes": [
                        {
                            key: not_measured(r.get(key))
                            for key in ("padded", "chips", "k", "shards", "ms",
                                        "unsharded_ms", "device_ms", "phase_ms",
                                        "combine_ms", "launches_per_call", "plain_ms",
                                        "bound_ms", "bound_by", "smi")
                        }
                        for r in sharded["rows"] if r.get("ms") is not None
                    ],
                },
            ],
            # The resident row update is a torch op, not a hand kernel (the
            # reference's XLA scatter, yoda_tpu/ops/kernel.py:662): launches are
            # runs (e)-(i)'s, (k)'s and (l)'s update_rows calls on the card
            # (runs (k)'s and (l)'s each held against the plain lowering),
            # times at the main path's fleet with 64 rows.
            "torch_ops": [
                {
                    "name": "update_rows",
                    "route": "torch",
                    "source": "yoda_tpu_torch/ops/kernel.py (TorchFleetKernel.update_rows)",
                    "replaces": "yoda_tpu/ops/kernel.py:662 apply_row_update (jitted :671)",
                    "launches": churn["row_update_launches"]
                    + preemption["row_update_launches"] + affinity["row_update_launches"]
                    + sum(run["row_update_launches"] for run in h_runs)
                    + nodehealth["row_update_launches"]
                    + sum(tenancy[p]["launches"]["update_rows"] for p in k_parts)
                    + sum(process[p]["launches"]["update_rows"] for p in l_parts)
                    + sum(n["update_rows"] for p in o_parts
                          for n in lanes[p]["lane_launches"].values())
                    + sum(chaos[p]["kernels"]["launches"]["update_rows"] for p in q_parts)
                    + sum(r_launches("update_rows").values()),
                    "launches_run_r": r_launches("update_rows"),
                    "launches_run_r_by_member": r_by_member("update_rows"),
                    "launches_run_q": {
                        p: chaos[p]["kernels"]["launches"]["update_rows"] for p in q_parts
                    },
                    "launches_run_h_speculation": background["h1"]["spec_row_updates"],
                    "launches_run_o": {
                        p: sum(n["update_rows"] for n in lanes[p]["lane_launches"].values())
                        for p in o_parts
                    },
                    "launches_run_l": {
                        p: process[p]["launches"]["update_rows"] for p in l_parts
                    },
                    "launches_run_k": {
                        p: tenancy[p]["launches"]["update_rows"] for p in k_parts
                    },
                    "max_abs_err": max(max(r["max_abs_err"] for r in update_rows),
                                       *(tenancy[p]["max_abs_err"]["update_rows"]
                                         for p in k_parts),
                                       *(process[p]["max_abs_err"]["update_rows"]
                                         for p in l_parts),
                                       *(chaos[p]["kernels"]["max_abs_err"]["update_rows"]
                                         for p in q_parts),
                                       *r_err("update_rows")),
                    "ms": update_main["ms"],
                    "plain_ms": update_main["put_static_ms"],
                    "bound_ms": update_main["bound_ms"],
                    "bound_by": "bytes",
                    "library_ms": update_main["library_ms"],
                    "shapes": [
                        {key: r[key] for key in ("padded", "rows", "ms", "put_static_ms",
                                                 "library_ms", "bound_ms", "smi")}
                        for r in update_rows
                    ],
                },
            ],
        }
        print(json.dumps(kernels))
        print(smi)
        print(
            json.dumps(
                {
                    "ok": True,
                    "device": {
                        "platform": "gpu",
                        "kind": kind,
                        "count": torch.cuda.device_count(),
                    },
                }
            )
        )
    finally:
        rerun.stop()
        obs_rerun.stop()
        tenancy_rerun.stop()
        pipeline_rerun.stop()
        lanes_rerun.stop()
        if chaos_rerun is not None:
            chaos_rerun.stop()
        if fed_rerun is not None:
            fed_rerun.stop()


if __name__ == "__main__":
    main()
