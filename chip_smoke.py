#!/usr/bin/env python3
"""Smoke run of the PyTorch port (redpanda_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure:

1. Build every CUDA kernel from redpanda_tpu_torch/csrc/ with nvcc (one
   nvcc per source, all started together) and print the build times.
2. Hold each kernel against its plain PyTorch version on the same CUDA
   tensors, bit for bit: the predicate (K1, rp_predicate_leg) over the
   DOCS x EXPRS table and a tree deeper than one stack word, as one
   crossing from a pinned block (copy up, kernel, bits down, events) and
   over the block left resident; 200 legs of an engine on fresh columns
   through its reused staging slots and a column-cache entry's block
   launched over as a hit, against the host predicate; the bench's 32768
   rows (the call over the launch's block resident on the card, as a cache
   hit runs it, and the C entry alone), and K1's whole leg (host
   columns packed, one crossing, the bits copied out) at 2048 and 32768
   rows beside the host predicate (eval_host_mask) on the same columns; the
   payload transform (K3/K4) over the hand-made edge rows of
   ops/transforms.py edge_cases with their specs and over the bench's rows,
   packed (stride 1160) with the buffer at every offset mod 16 and
   unpacked, then over the bench's staged rows in both output layouts for
   the projection and the uppercase spec. Print kernel ms (CUDA events: the
   call, and one launch of the C entry point alone), plain ms and the
   bound (the launch's device time comes in phase 10).
   Then redpanda_tpu_torch.entry.entry()'s record pipeline (K3's path,
   counted apart as payload_record) against the CPU run.
3. Drive TorchEngine(device="cuda") the way bench.py drives the engine:
   64 partitions x 32 records x ~1 KB JSON, row_stride 1152, GROUP 16
   ticks fused per launch, DEPTH 3 launches in flight, 160 ticks, for the
   columnar spec and the payload spec, plus the same shape with short
   messages so that records survive the projection. Every reply must be
   byte-identical to TorchEngine(device="cpu") on the same requests, and
   every kernel's launch count over this phase must be > 0. Print
   record_batches/s, stage times and H2D/D2H bytes and ms, and the parse
   ladder the engine's probe chose; the payload spec runs the
   pointer-table staging lane (t_explode_ptrs). Then, each lane with its
   own engine, counts set to 0 before it and read after it, and every
   reply compared with the CPU engine's:
   a. the columnar spec with the structural ladder pinned
      (structural_probe=False) and with the staged ladder pinned
      (structural_parse=False), in turns (structural, staged, staged,
      structural): rates and stage seconds of each;
   b. the passthrough spec where(level == "error") through gather framing
      (n_frame_gather > 0, no padded framing);
   c. the column cache (device_column_cache_mb=32): one cold launch per
      workload, then hit launches only, which must copy 0 bytes up and
      launch K1; its rate is the repeat-window rate, not the engine's;
      and the payload lane's host staging at the bench launch, joined
      blob against pointer table;
   d. the data policy's device leg (PolicyEngine, row_stride 2048) over a
      fetch of the 64 partitions x 32 records, equal to
      PolicyEngine(device="cpu")'s device leg and to its host evaluator,
      K4 launched; and a failing K4 launch raising from transform_batches;
   e. the host-stage pool: the columnar spec and then the payload spec
      inline (host_workers=0) and on the pool (host_workers=4,
      host_pool_probe=False) in turns (inline, pool, inline, pool), then
      the passthrough spec inline, on the pinned pool (its reply-wide seal
      fanned out) and on a probed engine (what its pool probe chose):
      rates and the pool's, seal and harvest-thread stage seconds of each,
      K1 one launch a shard a launch on the pool lane, K4 one launch a
      launch staged from the pointer table on both lanes; then the seal seconds of the empty-reply lanes
      split into garbage collection and host work (seal_profile, which
      chip_tools/gc_profile.py also runs against another checkout);
   f. on the card nothing takes a mask's place: a K1 launch that fails in
      every shard and in the inline retry, and a copy down that fails on
      the harvest thread, both end in the script's error policy (skip:
      empty items; deregister: unloaded), with their failures counted;
   g. the fault envelope, armed through the port's honey badger, on a
      default columnar engine and a payload engine with
      breaker_cooldown_ms=200: a one-shot exception on each device domain
      (dispatch, the caller's mask fetch, the harvest thread's copy down)
      is retried to the CPU engine's reply with the breakers closed; a
      persistent one exhausts the envelope launch by launch into the
      policy (skip: empty; deregister: unloaded) until the dispatch
      breaker opens; the next launch makes no kernel launch; after the
      cooldown the half-open probe launches the kernel once, the breaker
      closes and the replies are byte-identical again; the journal holds
      the breaker's transitions as consistent pairs. Then a wedge past
      device_deadline_ms=50 raises DeadlineExceeded into the policy within
      the governor's envelope bound. The times to trip and to recover and
      the bound are printed, and every exhausted launch is one sample of
      coproc_failures_total. Before the faults: the pool probe's passes,
      whose device legs run on fetch workers, leave the engine's stats
      alone; and the default columnar and payload engines with their legs
      on fetch workers (as shipped) and inline, in turns, with the hop's
      seconds (t_leg_hop) beside each rate, and the copy-up interval
      (t_dev_h2d) beside the host's enqueue of the copies (t_h2d_enqueue).
   h. the budget plane and admission (TorchEngine(budget_plane=)), at the
      bench's request (64 partitions x 32 records of ~1 KB, GROUP ticks a
      group): (a) on the default plane (512 MiB, coproc 128 MiB) a columnar
      and a payload engine submit groups without harvesting: the first shed
      comes at the group the group's bytes predict (printed), makes no K1/K4
      launch and copies nothing up, with the held bytes unchanged; the
      oldest tickets are harvested one by one and the next group is admitted
      after exactly as many as the freed bytes predict (printed); once every
      ticket is harvested nothing is held, and the journal has one shed and
      one resumed; (b) with a plane that never sheds, the replies of both
      lanes are byte-identical to a plane-less engine's and the CPU
      engine's; (c) a persistent dispatch fault and a persistent harvest
      fault (honey badger) each leave nothing held after they raise into
      the policy; (d) an engine whose column cache two submits fill is
      pushed past 0.90 through the plane's storage account: the cache
      evicts to half its budget, torch.cuda.memory_allocated falls by at
      least the evicted entries' CUDA bytes (memory_reserved printed), the
      evicted window misses and launches K1 with its copy up, and the
      release brings back ok and the whole budget; (e) the default
      columnar and payload lanes with a never-shedding plane and without,
      in turns: rates and n_shed_submits (information, no gate).
   i. the columnar backend probe (TorchEngine.reset_columnar_probe() before
      each probe and last): an unpinned engine's first launch times the
      host predicate against K1's launch and fetch and publishes a
      process-wide verdict, printed with t_host_s, t_device_s and the
      probe's K1 launches (two), with exactly one COLUMNAR_BACKEND journal
      record an engine: first one bench request (2048 rows), then a fresh
      engine's full group as the lane sends it (GROUP x 2048 rows); after a
      warm-up the second engine's lane follows its verdict, its replies
      byte-identical to the CPU engine's; then force_mode="columnar_host"
      and "columnar_device" lanes, both inline (host_workers=0), in turns,
      two rounds, with each half's rate (the host half launches no K1 and
      copies nothing up) and its stages beside t_dispatch: t_leg_hop,
      t_harvest_wait, t_fetch, t_dev_h2d / t_dev_kernel / t_dev_d2h and
      t_leg_enqueue (the host's time in K1's crossings).
   j. lockwatch and leakwatch (coproc/lockwatch.py, coproc/leakwatch.py):
      four rounds in turns, the recorders on, off, on, off (enabled before
      the engines are built, as they must be), each driving the columnar
      spec (K1 pinned) and the payload spec (K4), inline and on the pool
      (host_workers=4, host_pool_probe=False), every engine with a budget
      plane that never sheds, the bench and short_msgs workloads, every
      reply compared with the CPU engine's and the first "on" round's with
      the first "off" round's; in the first round each engine also takes a
      one-shot fault on each coproc probe point (dispatch, the caller's mask
      fetch, the harvest thread's copy down, a shard worker), retried to the
      same reply. Then the observed lock-order edges (their number and
      whether they are a subset of pandalint's static graph over
      redpanda_tpu_torch/, which tools/pandalint builds here), every
      balance (all zero) and the imbalances (0) are printed, and the bench
      rate of each lane in each round (a cost figure, not a claim).
   k. a sandboxed python transform (TorchEngine.enable_py_sandboxed, one
      that keeps the "error" records and upper-cases them) over the bench
      launch (GROUP requests in one launch) on the card's engine, inline
      (host_workers=0) and on the default probed pool (host_workers=4,
      whose probe times a python plan's explode only): replies
      byte-identical to TorchEngine(device="cpu")'s, its record_batches/s
      printed; a counting callable (enable_py_transform) runs once a record
      of a launch; then a script that trips the ``**`` operand guard under
      deregister: the reply deregisters it, one TREND watchdog_kill is
      journaled, and the pool's measured decision stands. A python plan has
      no device stage: nothing is launched.
   Every other card engine of this script pins K1 (force_mode=
   "columnar_device"), so that a "host" verdict cannot take K1 off a path
   whose launches are counted. Phase 3's payload lane prints the host's
   enqueue of its copies up (t_h2d_enqueue) beside t_dev_h2d.
   Every engine of the other phases must end with no n_failures_* or
   n_retries count and every breaker closed.
   The host-ladder lanes (3a-3c) run inline (host_workers=0); phase 3's default
   engines take the pool when its probe (the launch's host path timed
   inline and sharded) pins it.
4. CRC-32C (K5, K6: the split CRC kernel over one block) against the
   plain versions at r = 100, 2048, 4097 and 16384 over 256, 1024 and 8192
   rows (64 and 512 more of 16384: 1, 2, 4 and 8 warps a row), aligned and
   one byte off, at edge and random lengths (random bytes past each), bit
   for bit; the call and the launch alone at the raft shape (K5) and the
   produce shape (K6).
5. Produce path (BASELINE config 1, bench.py run_config1_crc_validate):
   1024 one-record batches of 1 KiB values, r = 2048, through
   CrcBackend("device") with one corrupted claimed CRC and through
   CrcBackend.pick(regions, reps=8). Flags must equal the host backend's.
6. Raft follower (BASELINE config 5): 256 partitions x 4 batches of just
   under 16 KiB (1024 rows of 16384) through RaftDevicePlane(probe=False)
   and a probing plane; flags must equal the host oracle's.
7. Recovery scan: a 32 MiB segment of ~4 KiB batches (8192 frames) with a
   torn tail and with a corrupt frame; scan_valid_prefix_device must equal
   scan_valid_prefix_host.
   b. A broker restart over config 4's 64 partitions (the storage layer,
      redpanda_tpu_torch/storage/): a LogManager with
      LogConfig(use_device_recovery=True, recovery_device=the card) fills
      each partition with 1024 of phase 7's ~4 KiB batches (4 MiB a tail,
      256 MiB in all, at the default 128 MiB segment size) and stops; the
      last frame of every tail is torn in half and one partition has a
      payload byte flipped three frames from the end; the directory is
      copied and reopened log by log, once with device recovery (DiskLog.open
      -> recover_segment -> K5, exactly one crc32c launch a partition,
      counted) and once, the copy, with host recovery. The offsets and cuts
      must equal the host scan's, the last 32 batches of every log verify
      their Kafka CRCs, one more append a log lands at dirty + 1 on both,
      and every .log and .index file is byte-identical between the two.
      Print both reopens' wall times, MB/s over the tails and each one's
      median per-log open.
   c. The coproc runtime over config 4 (redpanda_tpu_torch/coproc/api.py,
      pacemaker.py, wasm_event.py over kafka/server/broker.py): a
      StorageApi, Broker and CoprocApi(broker, device=the card) with the
      default knobs; topic bench of 64 partitions holding 64 batches of 32
      ~1 KB JSON records each (the bench's short_msgs workload, seeded by
      batch); the columnar spec deployed as errs and the payload spec as
      errs_v1 through api.deploy (events into coprocessor_internal_topic);
      the pacemaker's ticks transform the backlog on the card. Every
      materialized partition's records must equal the same input through a
      TorchEngine(**PIN_K1) run directly, every materialized batch verify
      its CRC, the saved offsets name every partition at 2047, and nothing
      may count a failure. The columnar probe decides (its verdict is
      printed): K1 must launch at least once (the probe's leg) and K4 at
      least once a tick of errs_v1. Then a restart over the same directory
      (recover_topics, a new CoprocApi): both scripts come back from the
      event log, no materialized high watermark moves over 1 s of idle, and
      one more batch a partition appears once. Print each script's input
      record_batches/s from its deploy to its last offset, its ticks (its
      coproc.tick spans), the medians of its read, submit, harvest and
      write spans, the autotune's knobs and ADMISSION records.
   d. BASELINE config 5 through raft (redpanda_tpu_torch/rpc/ and raft/):
      three brokers in this process, each a StorageApi under a temporary
      directory, an rpc.Server on 127.0.0.1:0, a ConnectionCache to the
      other two and a GroupManager(device=the card) (election timeout
      5000 ms, heartbeat 500 ms: see CONFIG5_ELECTION_MS), the process's
      open-file limit raised to its hard limit where short; 256 groups
      NTP("kafka", "config5", p), all three nodes voters, each with a
      leader that held one election timeout. Four rounds, each replicating
      16 batches of 16 x 1000 B a group at quorum_ack, all groups at once
      (4096 batches, ~64 MiB a replica), a batch whose leader an election
      deposed resent to the new one: run A with
      RaftDevicePlane(probe=False) installed under every follower's append
      (K5), a torn round with the honey badger flipping a byte of 8
      appends (raft_crc_rejected rises by 8, the leaders' recovery resends
      them), run B with a two-shard virtual mesh plane (K8 on every append,
      K7 on every heartbeat tick that heard both peers, each tick's
      last_tick_acks equal to a numpy count of its acks) and run C on the
      default probing plane (its decision printed). After each round every
      replica of the round's range is byte-identical to its leader's and
      the leader holds every batch sent; K5's (K8's) launches lie between
      the appends that carried batches and the plane's validations. Print
      each round's batches/s and MB/s, raft_replicate_hist's p50 and p99,
      the plane's counts, the ticks and _tally_acks' time, how late the
      loop's timers fired, the leaders per node and the elections after
      the first stable view, and the replicate median beside phase 6's
      plane-only ms per append.
   e. BASELINE config 5 through the controller (redpanda_tpu_torch/
      cluster/): four brokers in this process, each phase 7d's broker
      (5000/500 ms) with the control plane a broker's start builds: the
      Controller on raft group 0 (its voters the four seed brokers), its
      ControllerDispatcher and ControllerBackend (leaders and shard tables,
      moves finished through the dispatcher), the leadership gossip
      (MetadataDisseminationService, md_dissemination_service) and
      ClusterService on its rpc server, a Broker wired to them (the
      controller's topic table, controller_dispatcher,
      controller_leader_fn, a MetadataCache) and a DataPolicyTable attached
      to the controller; the pinned single-card plane installed after one
      validate at each row width from 64 B to 64 KiB. Three brokers start
      the control plane and register themselves; the fourth's rpc server
      listens from the start and its control plane starts in step 4. In
      order, each check a failure: (1) create_topic("config5", 256
      partitions, replication 3) through a broker that is not the
      controller leader (ControllerDispatcher.topic_op): every topic table
      holds the same 256 assignments, every PartitionManager hosts exactly
      its assigned replicas (768 in all), each group's leader held one
      election timeout, and every MetadataCache.get_leader names the
      partition's raft leader; (2) one create_data_policy command through a
      non-leader's dispatcher reaches every node's table; (3) one round of
      phase 7d's batches (4096 batches of ~16.2 KB) through each leader's
      Partition.replicate at quorum_ack, every replica's range equal to its
      leader's, raft_crc_rejected unmoved, K5's launches (counted per
      append's node and group) at least the follower appends that carried
      batches, group 0's apart from the data groups'; (4) the fourth broker
      replays the controller log, joins through join_cluster via a
      non-leader seed, and 16 partitions each move one replica (not the
      leader) to it through Controller.move_partition_replicas: it hosts
      them, the dropped replicas are gone, each moved range is
      byte-identical to its leader's, and its catch-up appends launched K5;
      (5) delete_topic through a non-leader broker: every group and log
      directory of the topic gone on every node, and the leaders-table
      entries of the brokers that hosted its partitions. Print each step's
      seconds (create to materialized, stable leaders and converged
      metadata), the round's batches/s, MB/s and raft_replicate_hist p50 and
      p99, group 0's appends and K5 launches beside the data groups', the
      loop's timer lateness in each step and the elections after the first
      stable view.
   f. The Kafka front door (BASELINE configs 1 and 2 over the wire): one
      Broker(device="cuda") with a KafkaServer on 127.0.0.1 (port 0) and
      the port's KafkaClient, the produce path's CRC backend pinned to
      CrcBackend("device") (crc_backend.install_default_backend), in order:
      (a) config 1: one partition, 4096 batches of 16 JSON records of 1 KiB
      (64 MiB), one batch a PRODUCE request at acks=-1, 8 requests in
      flight on one connection; then a batch with one flipped record byte,
      answered corrupt_message by K6's verdict with the high watermark
      unmoved; K6's launches equal the requests (one a partition of a
      request); everything fetched back from offset 0 byte-identical; (b)
      config 2: 16 partitions, 256 LZ4 batches of 16 x 1 KiB records a
      partition, each PRODUCE request carrying one batch of every
      partition: K6's launches equal requests x 16, every partition
      fetched back byte-identical; (c) a v1 data policy on config 1's
      topic (Broker.set_data_policy): four fetches of 1 MiB (~1000
      records: K4, one launch each, asserted) and one of 16 KiB (16
      records: the host leg), every response's records equal to
      PolicyEngine(device="cpu")'s view of the same batches; (d) the
      backend unpinned: one produce request picks it (the decision and
      both rates printed; K6 launched by the probe, and by the request if
      the card won). Print each config's batches/s and MB/s,
      kafka_produce_hist p50 and p99 and the fetch MB/s beside the card's
      name and power limit.
   g. An exactly-once read-process-write loop over the Kafka wire (the
      ducktape tx_verifier_test shape; kafka/server group and transaction
      coordinators, cluster/rm_stm.py, kafka/client producer.py and
      consumer.py): one Broker(device="cuda") with a KafkaServer, K6 pinned
      as in 7f; config 2's shape (16 partitions of LZ4 batches of 16 x 1 KiB
      JSON records, 64 batches a partition, 16 MiB of records) produced by
      an idempotent TransactionalProducer at acks=-1, each partition's
      batches in order, the 16 partitions at once; a group of 2
      GroupConsumers (range assignment, 8 partitions each) polls
      read_committed, and each member's own TransactionalProducer writes a
      poll's records (2 batches a partition) to the output partition of the
      same index, sends the offsets to the group and commits; every 8th
      transaction of a member aborts and its input is polled again. Checks,
      each a failure: K6's launches equal the produce requests (one
      partition each: control markers and offset records are the broker's
      appends, not validated); a fresh read_committed reader of the output
      finds every input record exactly once and no batch of an aborted
      transaction; every output partition's LSO equals its high watermark;
      the group's committed offsets equal the input's high watermarks; the
      first member's transactional id re-initialised fences the old
      producer (invalid_producer_epoch); 4 read_committed fetches of 1 MiB
      through a v1 data policy on the output launch K4 once each and equal
      PolicyEngine(device="cpu")'s view (the policy also evaluates the
      control batches, as the reference's does); a restart with device
      recovery keeps the transactions, the pid block, every partition's
      high watermark, LSO and aborted ranges, and the group's offsets (K5's
      launches printed as measured: frames wider than 4096 B recover on
      the host). Print committed transactions/s, input records/s through
      the loop, kafka_produce_hist p50 and p99, the launches and the
      phase's seconds beside the card's name and power limit.
8. LZ4 (K11): the block decoder against its plain version over valid,
   overflowing, truncated, bad-offset and empty streams (all three
   outputs), and over the edge streams of ops/lz4_device.py edge_streams
   in shared memory (max_out 128, 77 with unaligned rows of 515, 1024) and
   on the global rows (max_out 49152: one warp's slice past 48 KB); then
   16384 text-like 1 KiB records (BASELINE config 2's 16 partitions x 1024
   records) decoded on the card, every row equal to its source, and
   measure_probe (device MB/s against host liblz4).
9. The partition mesh on a virtual mesh of four shards on the one card
   (partition_mesh(devices=[cuda:0] * 4): one card holding four shards; it
   runs every mesh kernel and copy, and measures nothing about scaling
   across cards):
   a. the mesh kernels against their plain versions, bit for bit: the vote
      tally (K7) over [4, 256] and [4, 1] votes and over 200 calls on
      fresh votes made on the card, with its launches and copies per call,
      timed on votes on the card and on host numpy votes (and torch.sum's
      time beside it), the sharded CRC check (K9) over [256, 4, 16384]
      (config 5's append: three claims wrong, a zero-length row, garbage
      past each length), the CRC + vote step (K8) over the same rows as
      [4, 256, 16384] with [4, 256] votes (one launch a call each, and no
      vote_tally launch for K8, asserted; each call timed beside one launch
      of its entry point alone, K9's also with the L2 cache flushed), both
      on the edge set (64 rows of 16384, 8192 and 5000 bytes, split across
      8, 4 and 2 warps, and of 100, one warp each and unaligned; lengths 0,
      -3, r + 5 and on every span and round boundary) and K8 over 200
      calls on inputs made on the card, the stacked predicate (K2) over
      the DOCS x EXPRS table cut into 4 shards with one empty and over the
      bench's 32768 rows range-sharded 4 ways (one launch a call per card
      chunk, asserted; the call timed beside one launch of its kernel
      alone), and the coproc step (K10) at full width: 64 partitions x 4
      batches of <= 16 KiB, 64 x 512 records of ~1 KB JSON (r_rec 1152)
      and [64, 256] votes (one fused launch a step and no other kernel,
      asserted; the step timed beside its launch alone);
   b. the engine's mesh lane at the bench's shape through
      TorchEngine(mesh=..., mesh_probe=False, host_workers=4) (the shards'
      ladders on the pool), columnar spec, both workloads: every reply
      byte-identical to the CPU engine's, the stacked predicate launched
      once per mesh launch and card chunk and the single one not, rows per
      device summing to the records, its t_dispatch beside the single
      lane's; then one engine with mesh_probe=True and its decision;
   c. the raft plane's mesh leg at config 5's shape
      (RaftDevicePlane(mesh=..., probe=False).validate, 1024 regions: one
      crc32c_vote launch, asserted) and tally_votes over [4, 256], timed
      host to host, and the mesh leg and the single-device leg timed in
      turns on the same append (median of 5 each);
   d. redpanda_tpu_torch.entry.dryrun_multichip(4) on the virtual mesh.
10. torch.profiler's device time of one K3, K4, K5 and K6 launch each
    (rows in L2, and the L2 cache flushed), after every path, so that no
    path is timed behind a profiler session.
11. Print the kernels line, the card's name and power limit, and last the
    {"ok": true, "device": ...} line.

Phases 3, 3h, 3i, 3j, 5-8 (7b, 7c, each round of 7d, 7e whole and its round, each step of 7f, and
7g's loop and its policy fetches) and 9b-9d, and the K9, K8 and K10 runs of 9a, each set
every launch count to 0 just before their path and fail if a kernel of that
path was not launched in it.

Without a CUDA device it exits 1 before printing any result.
"""

from __future__ import annotations

import contextvars
import functools
import json
import os
import subprocess
import sys
import time

P = 64  # partitions
RECORDS_PER_BATCH = 32
RECORD_JSON_PAD = 900  # ~1 KB records
ROW_STRIDE = 1152
GROUP = 16  # ticks fused per launch
DEPTH = 3  # launch groups in flight
TICKS = 160
PRODUCE_BATCHES = 1024  # bench.py config 1: 64 batches x 16
RAFT_PARTITIONS, RAFT_BATCHES = 256, 4  # config 5: batches per append
RAFT_VALUE, RAFT_RECORDS = 1000, 16  # a region just under 16 KiB
SEGMENT_FRAMES, SEGMENT_RECORDS, SEGMENT_VALUE = 8192, 4, 1000  # ~4 KiB frames, 32 MiB
RESTART_BATCHES = 1024  # phase 7b: 4 MiB a partition's tail (the segment holds 128 MiB)
LZ4_RECORDS, LZ4_RECORD = 16 * 1024, 1024  # config 2: 16 partitions x 1024 records
MESH_SHARDS = 4  # the virtual mesh's shards on the one card
VOTE_GROUPS = 256  # raft groups in a vote tally
STEP_BATCHES, STEP_RECORDS = 4, 512  # K10 per partition: batches of <= 16 KiB, ~1 KB records
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
SCALAR_OPS_PER_S = 67e12  # H100 SXM float32 rate outside the tensor cores
# Every card engine of the phases that count K1's launches pins it: the
# columnar backend probe's verdict (phase 3i) is process-wide, and a "host"
# verdict would take K1 off their paths. Phase 3i's default engine alone runs
# unpinned.
PIN_K1 = {"force_mode": "columnar_device"}


def log(*args) -> None:
    print(*args, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


# ------------------------------------------------------------------ inputs
def build_request(short_msgs: bool, seed: int = 0):
    """The bench's request (bench.py _build_workload): one batch of 32 JSON
    records per partition. ``short_msgs`` keeps the ~1 KB size in a pad
    field and draws msg lengths around the projection's 64 bytes, with one
    record wider than the staging row."""
    import numpy as np

    from redpanda_tpu_torch.coproc.engine import ProcessBatchItem, ProcessBatchRequest
    from redpanda_tpu_torch.models import NTP, Record, RecordBatch

    rng = np.random.default_rng(seed)
    levels = ["error", "info", "warn"]
    items = []
    for p in range(P):
        recs = []
        for i in range(RECORDS_PER_BATCH):
            pad = RECORD_JSON_PAD + int(rng.integers(0, 100))
            if short_msgs:
                msg = "m" * int(rng.integers(0, 90))
                if p == 7 and i == 3:
                    pad = ROW_STRIDE + 50
                doc = '{"level":"%s","code":%d,"msg":"%s","pad":"%s"}' % (
                    levels[(p + i) % 3], i - 5, msg, "y" * pad)
            else:
                doc = '{"level":"%s","code":%d,"msg":"%s"}' % (levels[(p + i) % 3], i, "x" * pad)
            recs.append(Record(offset_delta=i, timestamp_delta=i, value=doc.encode()))
        batch = RecordBatch.build(recs, base_offset=0, first_timestamp=1_000_000)
        items.append(ProcessBatchItem(1, NTP.kafka("bench", p), [batch]))
    return ProcessBatchRequest(items)


def passthrough_spec():
    from redpanda_tpu_torch.ops.exprs import field
    from redpanda_tpu_torch.ops.transforms import where

    return where(field("level") == "error")


def columnar_spec():
    from redpanda_tpu_torch.ops.exprs import field
    from redpanda_tpu_torch.ops.transforms import Int, Str, map_project, where

    return where(field("level") == "error") | map_project(Int("code"), Str("msg", 64))


def payload_spec():
    from redpanda_tpu_torch.ops.transforms import Int, Str, filter_field_eq, map_project

    return filter_field_eq("level", "error") | map_project(Int("code"), Str("msg", 64))


def docs_and_exprs():
    """The DOCS x EXPRS table of tests/test_exprs.py."""
    from redpanda_tpu_torch.ops.exprs import field

    docs = [
        {"level": "error", "code": 500, "msg": "boom"},
        {"level": "info", "code": 200, "msg": "fine"},
        {"level": "error", "code": 42, "msg": "xx"},
        {"level": "warn", "meta": {"retriable": True, "n": 3}, "code": 503},
        {"code": 1.5, "msg": "nolevel"},
        {"level": "error", "msg": "nocode"},
        {"level": "errorx", "code": 500},
        {"level": "", "code": 0},
        {"level": None, "code": -7},
        {"level": True, "code": 2**31 - 1},
        {"level": "error", "code": 2**31},
        {"level": "error", "code": 499.5},
        {"level": "error", "code": "500"},
        {"meta": {"retriable": False}},
        {"meta": "flat"},
        {"msg": "needle in a haystack", "code": 1},
        {"msg": "no ndl here", "code": 2},
        {"deep": {"a": {"b": 9}}},
        {},
    ]
    f = field
    exprs = [
        f("level") == "error", f("level") != "error", f("code") == 500, f("code") != 500,
        f("code") < 100, f("code") <= 42, f("code") > 499, f("code") >= 500, f("code") >= 499.6,
        f("level") == True, f("level") == None, f("level") != None,  # noqa: E711,E712
        f("level").exists(), ~f("level").exists(), f("meta.retriable") == True,  # noqa: E712
        f("meta.n") >= 3, f("deep.a.b") == 9, f("msg").contains(b"needle"),
        f("msg").contains(b"ndl", window=6),
        (f("level") == "error") & (f("code") >= 100),
        (f("level") == "error") | (f("code") < 2),
        ~((f("level") == "error") & (f("code") >= 100)),
        (f("level") == "error") & ((f("code") >= 500) | ~f("msg").exists()),
        f("msg").contains(b"hay", window=8) | f("msg").contains(b"x", window=64),
    ]
    vals = [json.dumps(d, separators=(",", ":")).encode() for d in docs]
    return vals, exprs


def deep_expr():
    """A tree whose evaluation stack is 150 deep: the kernel spills words."""
    from redpanda_tpu_torch.ops import exprs as E

    leaves = [E.field("code") >= k for k in range(-60, 90)]
    expr = leaves[-1]
    for i, leaf in enumerate(reversed(leaves[:-1])):
        expr = E.Or(leaf, expr) if i % 2 else E.And(leaf, expr)
    return expr


# ------------------------------------------------------------------ timing
def cuda_ms(fn, iters: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes: int, ops: int) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / SCALAR_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def max_abs_err(pairs) -> float:
    """Largest |kernel - plain| over (kernel, plain) tensor pairs."""
    import torch

    return max(
        (float((a.to(torch.int64) - b.to(torch.int64)).abs().max()) for a, b in pairs if a.numel()),
        default=0.0,
    )


def path_launches(path: str, *expected) -> dict:
    """Every kernel's launch count since the last reset; fails when a
    kernel of this path was not launched."""
    from redpanda_tpu_torch import kernels

    launches = {k.name: k.launches for k in kernels.KERNELS}
    for k in expected:
        if launches[k.name] <= 0:
            fail(f"kernel {k.name} was not launched on the {path} path")
    return {k.name: launches[k.name] for k in expected}


# ------------------------------------------------------------------ phases
def phase_predicate(dev) -> dict:
    import numpy as np
    import torch

    from redpanda_tpu_torch import kernels
    from redpanda_tpu_torch.coproc import batch_codec, colcache
    from redpanda_tpu_torch.coproc.column_plan import LegEvents, plan_spec, predicate_plain
    from redpanda_tpu_torch.coproc.engine import TorchEngine
    from redpanda_tpu_torch.ops.exprs import host_eval
    from redpanda_tpu_torch.ops.transforms import where

    def host_cols(plan, vals, n_pad):
        joined = b"".join(vals)
        offsets = np.cumsum([0] + [len(v) for v in vals[:-1]]).astype(np.int64)
        sizes = np.array([len(v) for v in vals], np.int32)
        return plan.extract_device_inputs(joined, offsets, sizes, n_pad)

    events = LegEvents()

    def crossing(plan, cols, n_pad):
        """One rp_predicate_leg crossing from a pinned block, then one over
        the block it left resident (a cache hit's launch): the bits of
        each."""
        lay = plan.block_layout(n_pad)
        host = torch.empty(lay.total, dtype=torch.uint8, pin_memory=True)
        lay.pack(cols, host.numpy())
        bits_host = torch.empty(n_pad // 8, dtype=torch.uint8, pin_memory=True)
        words = plan.spill_words() * n_pad
        block = torch.empty(lay.total, dtype=torch.uint8, device=dev)
        bits = torch.empty(n_pad // 8, dtype=torch.uint8, device=dev)
        scratch = torch.empty(words, dtype=torch.int64, device=dev) if words else None
        plan.predicate_leg(n_pad, block, bits, host_block=host, bits_host=bits_host,
                           events=events, scratch=scratch)
        events.wait()
        bits.zero_()
        plan.predicate_leg(n_pad, block, bits, scratch=scratch)
        return bits_host, bits.cpu()

    vals, exprs = docs_and_exprs()
    deep = plan_spec(where(deep_expr()))
    rng = np.random.default_rng(5)
    deep_vals = [b'{"code":%d}' % int(c) for c in rng.integers(-100, 100, 2003)]
    cases = [(f"EXPRS[{i}]", plan_spec(where(e)), vals, 24, e) for i, e in enumerate(exprs)]
    cases.append(("the deep tree", deep, deep_vals, 2008, None))
    for label, plan, vs, n_pad, expr in cases:
        cols = host_cols(plan, vs, n_pad)
        want = predicate_plain(plan, [torch.from_numpy(c) for c in cols])
        copied, resident = crossing(plan, cols, n_pad)
        if not torch.equal(copied, want):
            fail(f"K1's crossing from a pinned block != plain on {label}")
        if not torch.equal(resident, want):
            fail(f"K1 over a resident block != plain on {label}")
        if expr is not None:
            oracle = np.array([host_eval(expr, v) for v in vs])
            if not (np.unpackbits(want.numpy())[: len(vs)].astype(bool) == oracle).all():
                fail(f"predicate plain != host oracle on {label}")
    log(f"K1 parity (rp_predicate_leg): {len(exprs)} DOCS x EXPRS cases and a "
        f"depth-{deep.program.depth} tree bit-identical to the plain version, as one crossing "
        "from a pinned block and over the block left resident")

    # an engine's legs through its staging slots: 200 fresh launches, three in
    # flight at a time, and a column-cache entry's block launched over as a hit
    eng = TorchEngine(device=dev, **PIN_K1, row_stride=ROW_STRIDE, host_workers=0)
    plan = plan_spec(where(exprs[19]))
    inflight, checked = [], 0
    for k in range(200):
        n = int(rng.integers(100, 1900))
        vs = [b'{"level":"%s","code":%d}' % (
            [b"error", b"info", b"errorx"][int(rng.integers(0, 3))], int(rng.integers(-50, 300)))
            for _ in range(n)]
        cols = host_cols(plan, vs, 2048)
        inflight.append((eng._run_leg(plan, cols), cols))
        if len(inflight) == 3 or k == 199:
            for pending, c in inflight:
                if not np.array_equal(pending.wait(eng), plan.eval_host_mask(c)):
                    fail(f"K1 leg {checked} through a reused slot != the host predicate")
                checked += 1
            inflight = []
    slots = eng.leg_slot_stats()
    if slots["slots"] > 3 or slots["held"]:
        fail(f"K1 legs: staging slots {slots}")
    entry = colcache.Entry(n=n, n_pad=2048, ranges=[(0, n)], cols=cols)
    want = plan.eval_host_mask(cols)
    cold = eng._run_leg(plan, cols, entry=entry).wait(eng)
    eng._run_leg(plan, host_cols(plan, vs[::-1], 2048)).wait(eng)
    hit = eng._run_leg(plan, cols, dev_block=entry.cols_dev).wait(eng)
    if not (np.array_equal(cold, want) and np.array_equal(hit, want)):
        fail("K1 leg over a cached block != the host predicate")
    log(f"K1 legs: {checked} fresh launches through {slots['slots']} reused staging slots "
        f"({slots['bytes']} B, {slots['grows']} growths) and a cache hit over an entry's block, "
        "all equal to the host predicate")

    # the bench's launch: GROUP ticks x 64 partitions x 32 records
    req = build_request(short_msgs=False)
    batches = [b for it in req.items for b in it.batches] * GROUP
    plan = plan_spec(columnar_spec())
    ex, types, vs_, ve = batch_codec.explode_and_find(batches, plan.flat_paths())
    cache = plan.make_cache_from_tables(ex, plan.flat_paths(), types, vs_, ve)
    n = len(ex.sizes)
    bench_cols = plan.extract_device_inputs(ex.joined, ex.offsets, ex.sizes, n, cache)
    # K1 over the launch's block resident on the card, as a cache hit runs it
    lay = plan.block_layout(n)
    packed = np.zeros(lay.total, np.uint8)
    lay.pack(bench_cols, packed)
    block = torch.from_numpy(packed).to(dev)
    cols = lay.views(block)
    bits = torch.empty(n // 8, dtype=torch.uint8, device=dev)
    plan.predicate_leg(n, block, bits)
    got = bits.clone()
    want = predicate_plain(plan, cols)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        fail("predicate kernel != plain at the bench shape")
    ms = cuda_ms(lambda: plan.predicate_leg(n, block, bits), 200)
    launch_ms = cuda_ms(raw_leg_launch(plan, n, block, bits, dev), 200)
    plain_ms = cuda_ms(lambda: predicate_plain(plan, cols), 20)
    nbytes = sum(c.nbytes for c in bench_cols) + n // 8
    b_ms, b_by = bound_ms(nbytes, n * len(plan.program.code))
    log(f"K1 bench shape: n={n} resident call {ms:.4f} ms (rp_predicate_leg alone "
        f"{launch_ms:.4f} ms), plain {plain_ms:.4f} ms, bound {b_ms * 1e3:.3f} us ({b_by}, "
        f"{nbytes} B)")
    # the whole leg, host columns to bits copied out of pinned memory, beside
    # the host predicate on the same columns (host clock, median of 200 each,
    # in turns)
    legs = {}
    for rows in (2048, n):
        cols_h = [c[:rows] for c in bench_cols] if rows < n else bench_cols
        cols_h = [np.ascontiguousarray(c) for c in cols_h]
        eng._run_leg(plan, cols_h).wait(eng)
        t_leg, t_host = [], []
        for _ in range(200):
            t0 = time.perf_counter()
            bits = eng._run_leg(plan, cols_h).wait(eng)
            t_leg.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            host_bits = plan.eval_host_mask(cols_h)
            t_host.append(time.perf_counter() - t0)
        if not np.array_equal(bits, host_bits):
            fail(f"K1 leg at {rows} rows != the host predicate")
        legs[rows] = (sorted(t_leg)[100] * 1e3, sorted(t_host)[100] * 1e3)
        log(f"K1 whole leg at {rows} rows (pack, one crossing, wait, bits copied out): median "
            f"{legs[rows][0]:.4f} ms against the host predicate's {legs[rows][1]:.4f} ms on the "
            f"same columns (median of 200 each, host clock; ratio "
            f"{legs[rows][1] / legs[rows][0]:.3f})")
    st = eng.stats()
    eng.shutdown()
    events.close()
    return {"max_abs_err": max_abs_err([(got, want)]), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "launch_ms": launch_ms,
            "leg_ms": {str(r): v[0] for r, v in legs.items()},
            "host_ms": {str(r): v[1] for r, v in legs.items()},
            "parity": f"bit-identical on {len(exprs)} EXPRS cases and a depth-"
                      f"{deep.program.depth} tree (resident and from a pinned block), "
                      f"{checked} legs through reused slots, a cache hit and the bench shape "
                      f"(n={n}); t_dev_kernel {st.get('t_dev_kernel', 0):.6f} s"}


def raw_leg_launch(plan, n_pad, block, bits, dev):
    """rp_predicate_leg over a resident block with the C entry point called
    directly (no wrapper, not counted, no copies, no events)."""
    from redpanda_tpu_torch import kernels

    code, needles = plan.program.on(dev)
    lay = plan.block_layout(n_pad)
    argv = (None, block.data_ptr(), 0, lay.c_off, len(lay.parts), code.data_ptr(),
            code.shape[0], needles.data_ptr(), n_pad, None, bits.data_ptr(), None, None,
            kernels.stream_handle(dev))
    fn = kernels.PREDICATE.fn()

    def run():
        if fn(*argv) != 0:
            fail("rp_predicate_leg refused its launch")

    return run


# torch.profiler sessions run after every path (phase_device_times), so that
# no path of this script is timed behind one: (label, the dict that takes
# the device times, a launch, the kernel's name)
PROFILE_LATER = []


def device_ms(fn, kernel_name: str, flush=None) -> float:
    """torch.profiler's device time of one call of ``fn`` (mean over 40),
    for the kernel whose name holds ``kernel_name``; with ``flush`` (a
    tensor on the card) the L2 cache is flushed before each call."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):  # the profiler now and then delivers no kernel record
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(40):
                if flush is not None:
                    flush.fill_(1)
                fn()
            torch.cuda.synchronize()
        ev = [e for e in prof.key_averages() if kernel_name in e.key]
        if ev:
            return ev[0].device_time_total / 1e3 / ev[0].count
    fail(f"the profiler saw no {kernel_name} time")


def phase_device_times(dev) -> None:
    """The device time of each launch PROFILE_LATER holds, with the rows in
    L2 and with the L2 cache flushed before each launch (a 128 MB write)."""
    import torch

    l2_flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    for label, target, run, name in PROFILE_LATER:
        target["device_ms"] = device_ms(run, name)
        target["device_l2_flushed_ms"] = device_ms(run, name, l2_flush)
        log(f"{label}: one launch {target['device_ms']:.4f} ms of device time by torch.profiler "
            f"({target['device_l2_flushed_ms']:.4f} with L2 flushed)")


def raw_payload_launch(prog, src, lens, dev):
    """One launch of rp_payload_transform over ``src`` (packed when lens is
    None) with the C entry point called directly (no wrapper, not counted):
    (fn, its outputs)."""
    import torch

    from redpanda_tpu_torch import kernels
    from redpanda_tpu_torch.ops.pipeline import OUT_META

    n = src.shape[0]
    desc, pats = prog.on(dev)
    if lens is None:
        outs = (torch.empty((n, prog.r_out + OUT_META), dtype=torch.uint8, device=dev),)
        ptrs = (outs[0].data_ptr(), outs[0].stride(0), None, None)
    else:
        outs = (torch.empty((n, prog.r_out), dtype=torch.uint8, device=dev),
                torch.empty(n, dtype=torch.int32, device=dev),
                torch.empty(n, dtype=torch.bool, device=dev))
        ptrs = (outs[0].data_ptr(), outs[0].stride(0), outs[1].data_ptr(), outs[2].data_ptr())
    argv = (src.data_ptr(), src.stride(0), None if lens is None else lens.data_ptr(), n,
            prog.r_in, *ptrs, prog.r_out, 1, desc.data_ptr(), prog.n_filters, prog.mapper,
            prog.n_fields, pats.data_ptr(), kernels.stream_handle(dev))
    fn = kernels.PAYLOAD_TRANSFORM.fn()

    def run():
        if fn(*argv) != 0:
            fail("rp_payload_transform refused its launch")

    run.tensors = (src, lens, outs, desc, pats)  # alive while the launch may run
    return run, outs


def staged_at(data, lens, offset: int, dev):
    """data u8 [n, r] and lens i32 [n] staged as the engine stages them
    ([n, r + IN_META]: the row, its LE32 length, 4 zero bytes) in a view
    whose first byte lies ``offset`` bytes past a 16-byte boundary and whose
    last byte ends the buffer's bytes the view covers."""
    import torch

    from redpanda_tpu_torch.ops.pipeline import IN_META

    n, r = data.shape
    buf = torch.zeros(n * (r + IN_META) + offset, dtype=torch.uint8, device=dev)
    staged = buf[offset:].view(n, r + IN_META)
    staged[:, :r] = data
    staged[:, r : r + 4] = lens.view(torch.uint8).reshape(n, 4)
    return staged


def payload_edges(dev) -> str:
    """The payload kernel against its plain version on the hand-made edge
    rows (ops/transforms.py edge_cases at r = 1152: window edges at 31/32/33
    and 127/128/129, matches ending at the length and at r, with and without
    the nonnum rule, lengths 0 and past r, Int and Str at their limits),
    packed with the staging buffer at every offset mod 16 (stride 1160) and
    unpacked at offsets 0 and 3, each view ending where its buffer ends;
    and the bench's first 2048 staged rows at every offset mod 16."""
    import torch

    from redpanda_tpu_torch.coproc import batch_codec
    from redpanda_tpu_torch.coproc.engine import pack_staged
    from redpanda_tpu_torch.ops.pipeline import (
        IN_META, packed_plain, record_plain, run_packed, run_record)
    from redpanda_tpu_torch.ops.transforms import compile_transform, edge_cases

    data_np, lens_np, specs = edge_cases(ROW_STRIDE)
    data, lens = torch.from_numpy(data_np).to(dev), torch.from_numpy(lens_np).to(dev)
    ex = batch_codec.explode_batches([b for it in build_request(False).items for b in it.batches])
    b_staged = torch.empty((len(ex.sizes), ROW_STRIDE + IN_META), dtype=torch.uint8)
    pack_staged(ex, ROW_STRIDE, b_staged.numpy())
    b_rows = b_staged[:, :ROW_STRIDE].contiguous().to(dev)
    b_lens = b_staged[:, ROW_STRIDE : ROW_STRIDE + 4].contiguous().view(torch.int32).reshape(-1)
    b_lens = b_lens.to(dev)
    cases = 0
    for si, spec in enumerate(specs + [payload_spec()]):
        prog = compile_transform(spec, ROW_STRIDE)
        sets = [("edge", data, lens)] + ([("bench", b_rows, b_lens)] if si == len(specs) else [])
        for name, d, ln in sets:
            for off in range(16):
                staged = staged_at(d, ln, off, dev)
                got, want = run_packed(prog, staged), packed_plain(prog, staged)
                kept = want[:, prog.r_out + 4].bool()
                if not (torch.equal(got[:, prog.r_out:], want[:, prog.r_out:])
                        and torch.equal(got[kept, : prog.r_out], want[kept, : prog.r_out])):
                    fail(f"payload kernel != plain on the {name} rows (spec {si}, offset {off})")
                cases += 1
            for off in (0, 3):
                buf = torch.zeros(d.numel() + off, dtype=torch.uint8, device=dev)
                dd = buf[off:].view(d.shape)
                dd.copy_(d)
                g_out, g_len, g_keep = run_record(prog, dd, ln)
                w_out, w_len, w_keep = record_plain(prog, dd, ln)
                if not (torch.equal(g_keep, w_keep) and torch.equal(g_len, w_len)
                        and torch.equal(g_out[w_keep], w_out[w_keep])):
                    fail(f"payload kernel != plain on the {name} rows, unpacked (spec {si}, "
                         f"offset {off})")
                cases += 1
    torch.cuda.synchronize()
    msg = (f"{len(lens_np)} edge rows x {len(specs)} edge specs and the bench's first "
           f"{b_rows.shape[0]} rows, packed at every offset mod 16 and unpacked at 0 and 3")
    log(f"K3/K4 edge sets: {cases} cases bit-identical to the plain version ({msg})")
    return msg


def phase_payload(dev) -> tuple[dict, dict]:
    import torch

    from redpanda_tpu_torch.coproc import batch_codec
    from redpanda_tpu_torch.coproc.engine import _bucket_rows, pack_staged
    from redpanda_tpu_torch.ops.pipeline import IN_META, OUT_META, packed_plain, record_plain
    from redpanda_tpu_torch.ops.pipeline import run_packed, run_record
    from redpanda_tpu_torch.ops.transforms import (
        compile_transform, filter_contains, map_uppercase)

    edges = payload_edges(dev)
    k4, k3 = {}, {}
    specs = {"project": payload_spec(), "uppercase": filter_contains(b"warn") | map_uppercase()}
    for short in (False, True):
        req = build_request(short_msgs=short)
        batches = [b for it in req.items for b in it.batches] * GROUP
        ex = batch_codec.explode_batches(batches)
        n_pad = _bucket_rows(len(ex.sizes))
        staged_np = torch.empty((n_pad, ROW_STRIDE + IN_META), dtype=torch.uint8)
        pack_staged(ex, ROW_STRIDE, staged_np.numpy())
        staged = staged_np.to(dev)
        for name, spec in specs.items():
            prog = compile_transform(spec, ROW_STRIDE)
            got = run_packed(prog, staged)
            want = packed_plain(prog, staged)
            torch.cuda.synchronize()
            keep = want[:, prog.r_out + 4].bool()
            if not (torch.equal(got[:, prog.r_out:], want[:, prog.r_out:])
                    and torch.equal(got[keep, : prog.r_out], want[keep, : prog.r_out])):
                fail(f"payload kernel != plain (packed, {name}, short={short})")
            data = staged[:, :ROW_STRIDE].contiguous()
            lens = staged[:, ROW_STRIDE : ROW_STRIDE + 4].contiguous().view(torch.int32).reshape(-1)
            g_out, g_len, g_keep = run_record(prog, data, lens)
            w_out, w_len, w_keep = record_plain(prog, data, lens)
            torch.cuda.synchronize()
            if not (torch.equal(g_keep, w_keep) and torch.equal(g_len, w_len)
                    and torch.equal(g_out[w_keep], w_out[w_keep])):
                fail(f"payload kernel != plain (unpacked, {name}, short={short})")
            log(f"K3/K4 parity ({name}, {'short' if short else 'bench'} msgs): "
                f"{int(keep.sum())} of {n_pad} rows kept, bit-identical in both layouts")
            if short:
                continue
            # K4 (packed) and K3 (unpacked): the call and one launch alone
            # (events); the launch's device time comes at the end
            tp, tu = (k4, k3) if name == "project" else ({}, {})
            for kid, t, call, src, ln in (
                    ("K4", tp, lambda: run_packed(prog, staged), staged, None),
                    ("K3", tu, lambda: run_record(prog, data, lens), data, lens)):
                run, _ = raw_payload_launch(prog, src, ln, dev)
                t.update(ms=cuda_ms(call, 50), launch_ms=cuda_ms(run, 50))
                PROFILE_LATER.append((f"{kid} bench shape ({name} spec)", t, run, "payload_kernel"))
            log(f"K4 bench shape ({name} spec): {n_pad} x {ROW_STRIDE + IN_META} B staged: call "
                f"{tp['ms']:.4f} ms, launch alone {tp['launch_ms']:.4f} ms")
            log(f"K3 bench shape ({name} spec): {n_pad} x {ROW_STRIDE} B rows: call "
                f"{tu['ms']:.4f} ms, launch alone {tu['launch_ms']:.4f} ms")
            if name != "project":
                continue
            plain_ms = cuda_ms(lambda: packed_plain(prog, staged), 3)
            plain_rec_ms = cuda_ms(lambda: record_plain(prog, data, lens), 3)
            nbytes = staged.nbytes + n_pad * (prog.r_out + OUT_META)
            b_ms, b_by = bound_ms(nbytes, staged.nbytes)
            rec_bytes = data.nbytes + lens.nbytes + n_pad * (prog.r_out + 5)
            b3_ms, b3_by = bound_ms(rec_bytes, data.nbytes)
            pinned = staged_np.pin_memory()
            h2d_ms = cuda_ms(lambda: staged.copy_(pinned, non_blocking=True), 10)
            log(f"K3/K4 plain {plain_rec_ms:.3f} / {plain_ms:.3f} ms, bound "
                f"{b3_ms * 1e3:.2f} / {b_ms * 1e3:.2f} us ({b_by}, {rec_bytes} / {nbytes} B); "
                f"staged H2D from pinned memory {h2d_ms:.3f} ms")
            # compared: the meta columns of every row, the output of kept rows
            k4.update(max_abs_err=max_abs_err([
                (got[:, prog.r_out:], want[:, prog.r_out:]),
                (got[keep, : prog.r_out], want[keep, : prog.r_out])]),
                      plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, h2d_ms=h2d_ms)
            k3.update(max_abs_err=max_abs_err([(g_keep, w_keep), (g_len, w_len),
                                               (g_out[w_keep], w_out[w_keep])]),
                      plain_ms=plain_rec_ms, bound_ms=b3_ms, bound_by=b3_by)
    parity = ("bit-identical (meta of every row, output of kept rows) for both specs in both "
              f"layouts, bench and short messages, and on {edges}")
    k4["parity"] = k3["parity"] = parity
    return k4, k3


def phase_payload_entry(dev) -> dict:
    """The graft entry's flagship program (redpanda_tpu_torch.entry.entry):
    the record pipeline, K3's path, against its plain version."""
    import torch

    from redpanda_tpu_torch import entry, kernels

    fn, args = entry.entry(dev)
    cpu_fn, cpu_args = entry.entry("cpu")
    kernels.reset_launches()  # the entry's path starts here
    got = fn(*args)
    launches = path_launches("entry", kernels.PAYLOAD_RECORD)  # and ends here
    want = cpu_fn(*cpu_args)
    keep = want[2]
    if not (torch.equal(got[2].cpu(), keep) and torch.equal(got[1].cpu(), want[1])
            and torch.equal(got[0].cpu()[keep], want[0][keep])):
        fail("entry(): the record pipeline differs from its plain version")
    log(f"entry(): the record pipeline on the card equals the CPU run; launches {launches}")
    return launches


def reply_bytes(reply):
    return [(it.script_id, it.source.partition, [b.encode_internal() for b in it.batches])
            for it in reply.items], list(reply.deregistered)


def run_stream(engine, req, n_ticks):
    """GROUP ticks per launch, DEPTH launches in flight, replies fully
    rebuilt on the critical path (bench.py _run_engine_stream)."""
    n_groups = (n_ticks + GROUP - 1) // GROUP
    pending, replies = [], []
    t0 = time.perf_counter()
    for g in range(n_groups):
        k = min(GROUP, n_ticks - g * GROUP)
        pending.append(engine.submit_group([req] * k))
        while len(pending) > DEPTH:
            replies.extend(t.result() for t in pending.pop(0))
    while pending:
        replies.extend(t.result() for t in pending.pop(0))
    elapsed = time.perf_counter() - t0
    return replies, n_ticks * len(req.items) / elapsed


class GcPauses:
    """The garbage collector's pauses while the block runs (gc.callbacks):
    ``pauses`` [start, end, generation]; ``by_gen`` {generation: [seconds,
    count]}. A generation-2 collection of this process takes ~0.1 s, a third
    or more of a 160-tick window, so every lane's rate is read beside it."""

    def __enter__(self):
        import gc

        self.pauses = []
        gc.callbacks.append(self._on_gc)
        return self

    def __exit__(self, *exc):
        import gc

        gc.callbacks.remove(self._on_gc)

    def _on_gc(self, phase, info):
        if phase == "start":
            self.pauses.append([time.perf_counter(), 0.0, info["generation"]])
        elif self.pauses:
            self.pauses[-1][1] = time.perf_counter()

    def by_gen(self) -> dict:
        out = {g: [0.0, 0] for g in (0, 1, 2)}
        for p0, p1, g in self.pauses:
            out[g][0] = round(out[g][0] + p1 - p0, 6)
            out[g][1] += 1
        return out


def phase_engine(dev) -> dict:
    from redpanda_tpu_torch import kernels
    from redpanda_tpu_torch.coproc.engine import TorchEngine

    specs = {"columnar": columnar_spec(), "payload": payload_spec()}
    work = {"bench": build_request(short_msgs=False), "short_msgs": build_request(short_msgs=True)}
    want = {}
    for sname, spec in specs.items():
        cpu = TorchEngine(device="cpu", row_stride=ROW_STRIDE)
        cpu.enable_coprocessors([(1, spec.to_json(), ("bench",))])
        for wname, req in work.items():
            want[sname, wname] = [reply_bytes(t.result()) for t in cpu.submit_group([req] * GROUP)]
        cpu.shutdown()  # its pool's threads must not outlive the reference
    engines = {}
    for sname, spec in specs.items():
        eng = TorchEngine(device=dev, **PIN_K1, row_stride=ROW_STRIDE)
        if eng.enable_coprocessors([(1, spec.to_json(), ("bench",))]) != [0]:
            fail(f"enable {sname}")
        run_stream(eng, work["bench"], GROUP + 1)  # warm-up
        eng.reset_stats()
        engines[sname] = eng

    kernels.reset_launches()  # the main path starts here
    results, dispatch = {}, {}
    for sname, eng in engines.items():
        for wname, req in work.items():
            n_ticks = TICKS if wname == "bench" else 2 * GROUP
            with GcPauses() as gcp:
                t0 = time.perf_counter()
                replies, rate = run_stream(eng, req, n_ticks)
                wall = time.perf_counter() - t0
            ref = want[sname, wname]
            for k, rep in enumerate(replies):
                if reply_bytes(rep) != ref[k % GROUP]:
                    fail(f"{sname} {wname}: CUDA reply {k} differs from the CPU engine's")
            kept = sum(len(b) for _, _, b in ref[0][0])
            results[sname, wname] = (rate, kept)
            if wname == "short_msgs" and kept == 0:
                fail(f"{sname} short_msgs: no output batch to compare")
            if wname == "bench":
                st = eng.stats()
                dispatch[sname] = st.get("t_dispatch", 0.0)
                stages = {k: round(v, 6) for k, v in sorted(st.items())
                          if k.startswith(("t_", "n_", "bytes_"))}
                log(f"engine {sname} bench: {rate:.1f} record_batches/s over {n_ticks} ticks "
                    f"(GROUP {GROUP}, DEPTH {DEPTH}); H2D {st.get('bytes_h2d', 0):.0f} B "
                    f"in {st.get('t_dev_h2d', 0) * 1e3:.3f} ms (of which the host's enqueue "
                    f"{st.get('t_h2d_enqueue', 0) * 1e3:.3f} ms, host clock), "
                    f"D2H {st.get('bytes_d2h', 0):.0f} B "
                    f"in {st.get('t_dev_d2h', 0) * 1e3:.3f} ms, kernel "
                    f"{st.get('t_dev_kernel', 0) * 1e3:.3f} ms")
                busy = (st.get("t_dev_h2d", 0) + st.get("t_dev_kernel", 0)
                        + st.get("t_dev_d2h", 0)) * rate / (n_ticks * len(req.items))
                log(f"engine {sname} stages: {json.dumps(stages)}")
                gc_s = sum(p1 - p0 for p0, p1, _ in gcp.pauses)
                log(f"engine {sname} bench: gc pauses {gc_s:.6f} s of the {wall:.6f} s window, "
                    f"[s, count] by generation {json.dumps(gcp.by_gen())}; without them "
                    f"{n_ticks * len(req.items) / (wall - gc_s):.1f} record_batches/s")
                log(f"engine {sname}: device stream busy {busy:.2%} of the wall "
                    "(sum of CUDA-event stream intervals)")
                check_envelope(f"engine {sname}", st)
                log(f"engine {sname}: the host pool probe chose "
                    f"{json.dumps(st.get('host_pool_probe'))} at {st['host_workers']:.0f} workers; "
                    f"{st.get('n_sharded_launches', 0):.0f} of {st['n_launches']:.0f} launches "
                    "sharded")
                if sname == "columnar":
                    log(f"engine columnar: the parse probe chose {st['parse_path']} "
                        f"({json.dumps(st.get('parse_probe'))})")
                elif not st.get("t_explode_ptrs") or st.get("t_explode"):
                    # sharded or not, one staging path: the pointer table
                    fail(f"payload: the pointer-table staging lane did not run {lane_stats(st)}")
            else:
                log(f"engine {sname} short_msgs: {rate:.1f} record_batches/s, "
                    f"{kept} output batches per tick, replies byte-identical to the CPU engine")
    launches = path_launches("engine", kernels.PREDICATE, kernels.PAYLOAD_TRANSFORM)
    for sname, eng in engines.items():
        check_envelope(f"engine {sname}", eng.stats())
        eng.shutdown()
    log(f"engine parity: every reply of both specs byte-identical to TorchEngine(cpu); "
        f"main-path launches {launches}")
    return launches, {"want": want, "work": work, "rates": results, "dispatch": dispatch}


def lane_stats(st: dict) -> str:
    return json.dumps({k: round(v, 6) for k, v in sorted(st.items())
                       if k.startswith(("t_", "n_", "bytes_"))})


def drive_lane(name, eng, work, want, n_ticks_of) -> tuple[dict, dict]:
    """Every workload through ``eng``, replies compared with the CPU
    engine's; (rate per workload, stats after the bench workload)."""
    rates, st = {}, None
    for wname, req in work.items():
        replies, rates[wname] = run_stream(eng, req, n_ticks_of(wname))
        for k, rep in enumerate(replies):
            if reply_bytes(rep) != want[wname][k % GROUP]:
                fail(f"{name} lane {wname}: CUDA reply {k} differs from the CPU engine's")
        if wname == "bench":
            st = eng.stats()
    check_envelope(f"{name} lane", eng.stats())
    return rates, st


def phase_host_ladder(dev, engine_run) -> dict:
    """Phase 3a-3c: the host ladder's lanes, each pinned on its own engine."""
    from redpanda_tpu_torch import kernels
    from redpanda_tpu_torch.coproc.engine import TorchEngine

    work = engine_run["work"]
    cpu = TorchEngine(device="cpu", row_stride=ROW_STRIDE)
    cpu.enable_coprocessors([(1, passthrough_spec().to_json(), ("bench",))])
    want = {"columnar": {w: engine_run["want"]["columnar", w] for w in work},
            "passthrough": {w: [reply_bytes(t.result()) for t in cpu.submit_group([r] * GROUP)]
                            for w, r in work.items()}}
    cpu.shutdown()
    # the inline ladders (host_workers=0): the pool lane is phase 3e's
    pinned = {"structural": dict(structural_probe=False, host_workers=0),
              "staged": dict(structural_parse=False, host_workers=0)}
    # the two pinned ladders in turns (ABBA): the host's spread is wider
    # than their difference in one pass
    lanes = [(f"{k} #{i}", "columnar", pinned[k])
             for i, k in ((1, "structural"), (1, "staged"), (2, "staged"), (2, "structural"))]
    lanes.append(("gather-framed passthrough", "passthrough", dict(host_workers=0)))
    launches = {}
    for name, sname, kw in lanes:
        spec = columnar_spec() if sname == "columnar" else passthrough_spec()
        eng = TorchEngine(device=dev, **PIN_K1, row_stride=ROW_STRIDE, **kw)
        if eng.enable_coprocessors([(1, spec.to_json(), ("bench",))]) != [0]:
            fail(f"enable the {name} lane")
        run_stream(eng, work["bench"], GROUP + 1)  # warm-up
        eng.reset_stats()
        kernels.reset_launches()  # this lane's path starts here
        rates, st = drive_lane(name, eng, work, want[sname], n_ticks_of)
        launches[name] = path_launches(f"{name} lane", kernels.PREDICATE)["predicate"]
        if name.startswith("structural") and not (
                st.get("t_explode_find2") and st.get("t_fused_extract")
                and "t_extract_pred" not in st):
            fail(f"structural lane: not the fused ladder {lane_stats(st)}")
        if name.startswith("staged") and not (st.get("t_explode_find")
                                              and "t_explode_find2" not in st):
            fail(f"staged lane: not the staged ladder {lane_stats(st)}")
        if name.endswith("passthrough") and not (st.get("n_frame_gather")
                                                 and "n_frame_padded" not in st):
            fail(f"passthrough lane: not gather-framed {lane_stats(st)}")
        eng.shutdown()
        busy = (st.get("t_dev_h2d", 0) + st.get("t_dev_kernel", 0)
                + st.get("t_dev_d2h", 0)) * rates["bench"] / (TICKS * P)
        log(f"engine {name} lane ({sname} spec, parse path {st['parse_path']}): bench "
            f"{rates['bench']:.1f} record_batches/s over {TICKS} ticks, short_msgs "
            f"{rates['short_msgs']:.1f}; replies byte-identical to TorchEngine(cpu); "
            f"K1 launches {launches[name]}; streams busy {busy:.2%} of the wall")
        log(f"engine {name} lane bench stages: {lane_stats(st)}")
    launches["colcache"] = phase_colcache(dev, work, want["columnar"], n_ticks_of)
    staging_ms(work["bench"])
    return launches


def staging_ms(req) -> None:
    """The payload lane's host staging at the bench launch (GROUP x 64
    batches): the joined-blob explode + pack beside the pointer-table one
    the engine runs, each into a fresh pinned staging tensor as the engine
    packs, best of 5 each, in turns."""
    import torch

    from redpanda_tpu_torch.coproc import batch_codec
    from redpanda_tpu_torch.coproc.engine import _bucket_rows, pack_staged, pack_staged_ptrs
    from redpanda_tpu_torch.ops.pipeline import IN_META

    batches = [b for it in req.items for b in it.batches] * GROUP
    shape = (_bucket_rows(len(batches) * RECORDS_PER_BATCH), ROW_STRIDE + IN_META)

    def pinned():
        return torch.empty(shape, dtype=torch.uint8, pin_memory=True).numpy()

    lanes = {
        "joined blob": lambda: pack_staged(batch_codec.explode_batches(batches), ROW_STRIDE,
                                           pinned()),
        "pointer table": lambda: pack_staged_ptrs(batch_codec.explode_ptrs(batches), ROW_STRIDE,
                                                  pinned()),
    }
    best = {k: float("inf") for k in lanes}
    for _ in range(5):
        for k, f in lanes.items():
            t0 = time.perf_counter()
            f()
            best[k] = min(best[k], (time.perf_counter() - t0) * 1e3)
    log("payload staging at the bench launch (explode + pack into pinned memory, host, "
        "best of 5): "
        + ", ".join(f"{k} {v:.3f} ms" for k, v in best.items()))


def phase_colcache(dev, work, want, n_ticks_of) -> int:
    """Phase 3c: hit launches of the column cache copy nothing up."""
    from redpanda_tpu_torch import kernels
    from redpanda_tpu_torch.coproc.engine import TorchEngine

    eng = TorchEngine(device=dev, **PIN_K1, row_stride=ROW_STRIDE, device_column_cache_mb=32,
                      host_workers=0)
    eng.enable_coprocessors([(1, columnar_spec().to_json(), ("bench",))])
    for wname, req in work.items():  # one cold launch per window fills the cache
        replies, _ = run_stream(eng, req, GROUP)
        if any(reply_bytes(r) != want[wname][k] for k, r in enumerate(replies)):
            fail(f"colcache cold launch {wname}: a reply differs from the CPU engine's")
    cold = eng.stats()
    eng.reset_stats()
    kernels.reset_launches()  # the hit launches start here
    rates, st = drive_lane("colcache", eng, work, want, n_ticks_of)
    n = path_launches("colcache hit lane", kernels.PREDICATE)["predicate"]
    end = eng.stats()
    eng.shutdown()
    if end.get("bytes_h2d", 0) != 0 or "n_colcache_miss" in end or end["n_colcache_hit"] != n:
        fail(f"colcache: hit launches copied up or missed {lane_stats(end)}")
    cc = end["colcache"]
    log(f"engine colcache lane (device_column_cache_mb=32; every launch after the first of a "
        f"window is a hit: a repeat-window rate, not the engine's): bench "
        f"{rates['bench']:.1f} record_batches/s, short_msgs {rates['short_msgs']:.1f}; "
        f"replies byte-identical to TorchEngine(cpu); {n} hit launches, K1 launched {n} times, "
        f"bytes_h2d {end.get('bytes_h2d', 0):.0f} (cold launches: "
        f"{cold.get('bytes_h2d', 0):.0f}); {cc['entries']} entries, {cc['bytes']} B held")
    log(f"engine colcache lane bench stages: {lane_stats(st)}")
    return n


def stage_line(st: dict, keys=("t_shard_", "t_sharded_", "t_seal", "t_harvest_wait",
                                 "t_fetch", "t_explode", "t_fused", "t_frame", "t_rebuild",
                                 "t_pack")) -> str:
    return json.dumps({k: round(v, 6) for k, v in sorted(st.items()) if k.startswith(keys)})


def phase_pool(dev, engine_run) -> int:
    """Phase 3e: the host-stage pool against the inline path on the bench
    shape, each lane its own engine, in turns (inline, pool, inline, pool)
    for the columnar spec, then the passthrough spec (whose replies carry
    data, so that the reply-wide seal fans out); every reply compared with
    the CPU engine's, K1's launches exact (one a shard a launch on the pool
    lane), no failure counted. Then the empty-reply seal profile and the
    two failures on the card (3f)."""
    from redpanda_tpu_torch import kernels
    from redpanda_tpu_torch.coproc.engine import TorchEngine

    work = engine_run["work"]
    cpu = TorchEngine(device="cpu", row_stride=ROW_STRIDE, host_workers=0)
    cpu.enable_coprocessors([(1, passthrough_spec().to_json(), ("bench",))])
    want = {"columnar": {w: engine_run["want"]["columnar", w] for w in work},
            "payload": {w: engine_run["want"]["payload", w] for w in work},
            "passthrough": {w: [reply_bytes(t.result()) for t in cpu.submit_group([r] * GROUP)]
                            for w, r in work.items()}}
    cpu.shutdown()
    lanes = {"inline": dict(host_workers=0), "pool": dict(host_workers=4, host_pool_probe=False),
             "probed": dict(host_workers=4)}
    turns = ((1, "inline"), (1, "pool"), (2, "inline"), (2, "pool"))
    order = [("columnar", k, i) for i, k in turns]
    order += [("payload", k, i) for i, k in turns]
    order += [("passthrough", k, 1) for k in ("inline", "pool", "probed")]
    specs = {"columnar": columnar_spec, "payload": payload_spec, "passthrough": passthrough_spec}
    k1 = 0
    for sname, lane, i in order:
        spec = specs[sname]()
        eng = TorchEngine(device=dev, **PIN_K1, row_stride=ROW_STRIDE, **lanes[lane])
        if eng.enable_coprocessors([(1, spec.to_json(), ("bench",))]) != [0]:
            fail(f"enable the {sname} {lane} lane")
        run_stream(eng, work["bench"], GROUP + 1)  # warm-up
        eng.reset_stats()
        kernels.reset_launches()  # this lane's path starts here
        with GcPauses() as gcp:
            rates, st = drive_lane(f"{sname} {lane} #{i}", eng, work, want[sname], n_ticks_of)
        end = eng.stats()
        eng.shutdown()
        sharded = end.get("n_sharded_launches", 0)
        if sname == "payload":
            # one K4 launch a launch on either lane, staged from the pointer table
            n = path_launches(f"payload {lane} lane", kernels.PAYLOAD_TRANSFORM)["payload_transform"]
            if (n != end["n_launches"] or sharded != (end["n_launches"] if lane == "pool" else 0)
                    or not end.get("t_explode_ptrs") or end.get("t_explode")):
                fail(f"payload {lane} lane: {n} K4 launches, {sharded} sharded "
                     f"{stage_line(end)}")
        else:
            n = path_launches(f"{sname} {lane} lane", kernels.PREDICATE)["predicate"]
            k1 += n
        if sname != "payload" and lane == "pool":
            if sharded != end["n_launches"] or n != 4 * sharded:
                fail(f"pool lane: {n} K1 launches for {sharded} sharded launches of 4 shards "
                     f"({end['n_launches']} launches)")
            if sname == "passthrough" and not end.get("t_sharded_seal"):
                fail(f"pool lane: the seal did not fan out {stage_line(end)}")
        elif sname != "payload" and lane == "inline" and (sharded or n != end["n_launches"]):
            fail(f"inline lane: {n} K1 launches for {end['n_launches']} launches, "
                 f"{sharded} sharded")
        elif lane == "probed":
            log(f"engine pool phase {sname} probed: the pool probe chose "
                f"{json.dumps(end.get('host_pool_probe'))}")
        log(f"engine pool phase {sname} {lane} #{i} (host_workers "
            f"{end['host_workers']:.0f}): bench {rates['bench']:.1f} record_batches/s over "
            f"{TICKS} ticks, short_msgs {rates['short_msgs']:.1f}; replies byte-identical to "
            f"TorchEngine(cpu); {'K4' if sname == 'payload' else 'K1'} launches {n} for "
            f"{end['n_launches']:.0f} launches "
            f"({sharded:.0f} sharded); gc pauses over both workloads [s, count] by "
            f"generation {json.dumps(gcp.by_gen())}")
        log(f"engine pool phase {sname} {lane} #{i} bench stages: {stage_line(st)}")
    seal_profile(dev, work, want["columnar"])
    phase_card_failures(dev, work)
    return k1


def seal_profile(dev, work, want) -> None:
    """Where the seal seconds of lanes with empty replies go (the columnar
    spec on the bench workload: every msg is wider than Str("msg", 64)):
    the inline lane and the column cache's hit lane, each on its own engine
    over TICKS ticks, with the garbage collector's pauses (gc.callbacks) and
    the engine's t_seal windows recorded, so that the seal's seconds split
    into collection and host work. An engine without a knob (an older
    checkout's, driven by chip_tools/gc_profile.py) runs without it."""
    import inspect

    from redpanda_tpu_torch.coproc.engine import TorchEngine

    knobs = inspect.signature(TorchEngine.__init__).parameters
    windows = []
    for lane, kw in (("inline", {}), ("colcache hits", dict(device_column_cache_mb=32))):
        kw = {k: v for k, v in dict(kw, host_workers=0, **PIN_K1).items() if k in knobs}
        eng = TorchEngine(device=dev, row_stride=ROW_STRIDE, **kw)
        eng.enable_coprocessors([(1, columnar_spec().to_json(), ("bench",))])
        run_stream(eng, work["bench"], GROUP + 1)  # warm-up (and the cold launches)
        eng.reset_stats()
        real_stat = eng._stat

        def stat(key, t0, real_stat=real_stat):
            if key == "t_seal":
                windows.append((t0, time.perf_counter()))
            real_stat(key, t0)

        eng._stat = stat
        windows.clear()
        with GcPauses() as gcp:
            replies, rate = run_stream(eng, work["bench"], TICKS)
        st = eng.stats()
        eng.shutdown()
        if any(reply_bytes(r) != want["bench"][k % GROUP] for k, r in enumerate(replies)):
            fail(f"seal profile {lane}: a reply differs from the CPU engine's")
        if "breakers" in st:  # an older checkout's engine has no envelope
            check_envelope(f"seal profile {lane}", st)
        inside = {g: 0.0 for g in (0, 1, 2)}
        for p0, p1, g in gcp.pauses:
            inside[g] += sum(max(0.0, min(p1, w1) - max(p0, w0)) for w0, w1 in windows)
        t_seal, gc_s = st.get("t_seal", 0.0), sum(inside.values())
        by_gen = json.dumps({g: round(v, 6) for g, v in inside.items()})
        log(f"seal profile, {lane}, columnar bench (empty replies), {TICKS} ticks: "
            f"{rate:.1f} record_batches/s; t_seal {t_seal:.6f} s in {len(windows)} windows, of "
            f"which gc {gc_s:.6f} s ({by_gen} by generation) and host work "
            f"{t_seal - gc_s:.6f} s; all gc pauses [s, count] {json.dumps(gcp.by_gen())}")


def gc_lanes(dev, work, want, rounds: int = 3) -> None:
    """The columnar bench lane (TICKS ticks) on the default engine and on
    the inline one (host_workers=0, where the engine has that knob), in
    turns, each on its own engine, with the collector's pauses in the
    window beside the rate, so that a lane is compared with the pauses taken
    out as well as in."""
    import inspect

    from redpanda_tpu_torch.coproc.engine import TorchEngine

    knobs = inspect.signature(TorchEngine.__init__).parameters
    pin = {k: v for k, v in PIN_K1.items() if k in knobs}
    lanes = {"default": pin}
    if "host_workers" in knobs:
        lanes["inline"] = dict(pin, host_workers=0)
    for r in range(rounds):
        for lane, kw in lanes.items():
            eng = TorchEngine(device=dev, row_stride=ROW_STRIDE, **kw)
            eng.enable_coprocessors([(1, columnar_spec().to_json(), ("bench",))])
            run_stream(eng, work["bench"], GROUP + 1)  # warm-up
            eng.reset_stats()
            with GcPauses() as gcp:
                t0 = time.perf_counter()
                replies, rate = run_stream(eng, work["bench"], TICKS)
                wall = time.perf_counter() - t0
            st = eng.stats()
            eng.shutdown()
            if any(reply_bytes(x) != want["bench"][k % GROUP] for k, x in enumerate(replies)):
                fail(f"gc lanes {lane}: a reply differs from the CPU engine's")
            gc_s = sum(p1 - p0 for p0, p1, _ in gcp.pauses)
            log(f"gc lanes, {lane} #{r + 1}, columnar bench, {TICKS} ticks: {rate:.1f} "
                f"record_batches/s ({wall:.6f} s); gc pauses {gc_s:.6f} s, [s, count] by "
                f"generation {json.dumps(gcp.by_gen())}; without them "
                f"{TICKS * P / (wall - gc_s):.1f} record_batches/s; sharded launches "
                f"{st.get('n_sharded_launches', 0):.0f} of {st['n_launches']:.0f}")


def check_envelope(name: str, st: dict) -> None:
    """Nothing of the fault envelope may pass quietly on a main path: no
    failure counted, no attempt retried, every domain's breaker closed."""
    bad = {k: v for k, v in st.items() if k.startswith("n_failures") or k == "n_retries"}
    not_closed = {d: b["state"] for d, b in st.get("breakers", {}).items()
                  if b["state"] != "closed"}
    if bad or not_closed:
        fail(f"{name}: the fault envelope acted on a main path: {bad} breakers {not_closed}")


def failures_total() -> float:
    """coproc_failures_total summed over its domains and kinds: one sample a
    failure, whichever lane or policy it met."""
    from redpanda_tpu_torch import metrics

    return sum(v for k, v in metrics.registry.snapshot().items()
               if k.startswith("coproc_failures_total{"))


def one_tick(eng, req):
    """One launch of ``req`` through ``eng``: its reply and wall seconds."""
    t0 = time.perf_counter()
    reply = eng.submit_group([req])[0].result()
    return reply, time.perf_counter() - t0


FAULT_COOLDOWN_MS = 200
WEDGE_DEADLINE_MS = 50


def phase_fault_envelope(dev, engine_run) -> None:
    """Phase 3g: the fault envelope on the card, armed through the port's
    honey badger (module docstring)."""
    from redpanda_tpu_torch import kernels
    from redpanda_tpu_torch.coproc import faults
    from redpanda_tpu_torch.finjector import honey_badger

    req = engine_run["work"]["short_msgs"]  # replies that carry output batches
    want = engine_run["want"]
    probe_keeps_no_stats(dev, engine_run["work"]["bench"])
    hop_lanes(dev, engine_run)
    honey_badger.enable()
    try:
        fault_lane(dev, "columnar", columnar_spec(), kernels.PREDICATE,
                   (faults.DEVICE_DISPATCH, faults.MASK_FETCH, faults.HARVEST), req,
                   want["columnar", "short_msgs"][0])
        fault_lane(dev, "payload", payload_spec(), kernels.PAYLOAD_TRANSFORM,
                   (faults.DEVICE_DISPATCH, faults.HARVEST), req, want["payload", "short_msgs"][0])
        wedge_lane(dev, req, want["columnar", "short_msgs"][0])
    finally:
        for module, armed in list(honey_badger.armed().items()):
            for probe in armed:
                honey_badger.unset(module, probe)
        honey_badger.disable()


def fault_lane(dev, sname, spec, kernel, domains, req, want) -> None:
    """Phase 3g on one default engine of ``spec``: one-shot faults
    retried, a persistent one tripping the dispatch breaker, the refused
    launch, the half-open recovery and the journal's transition pairs."""
    from redpanda_tpu_torch.coproc import faults, governor
    from redpanda_tpu_torch.coproc.engine import ErrorPolicy, TorchEngine
    from redpanda_tpu_torch.finjector import honey_badger
    from redpanda_tpu_torch.observability import probes

    eng = TorchEngine(device=dev, **PIN_K1, row_stride=ROW_STRIDE,
                      breaker_cooldown_ms=FAULT_COOLDOWN_MS)
    if eng.enable_coprocessors([(1, spec.to_json(), ("bench",))]) != [0]:
        fail(f"fault envelope: enable {sname}")
    run_stream(eng, req, GROUP + 1)  # warm-up: the probes decide before any fault
    check_envelope(f"fault envelope {sname} warm-up", eng.stats())
    dispatch = eng.governor.breaker_for(faults.DEVICE_DISPATCH)
    # 1. a one-shot exception on each domain is retried
    for domain in domains:
        eng.reset_stats()
        if domain == faults.MASK_FETCH:
            eng._harvest_async = lambda: False  # the caller fetches its masks
        honey_badger.set_exception(faults.MODULE, domain, count=1)
        try:
            reply, wall = one_tick(eng, req)
        finally:
            eng.__dict__.pop("_harvest_async", None)
        st = eng.stats()
        if reply_bytes(reply) != want:
            fail(f"fault envelope {sname}: a retried {domain} fault changed the reply")
        if honey_badger.armed() or st.get("n_retries", 0) < 1:
            fail(f"fault envelope {sname}: the one-shot {domain} fault was not retried "
                 f"({honey_badger.armed()}, {lane_stats(st)})")
        if any(k.startswith("n_failures") for k in st) or st["breaker"]["state"] != "closed":
            fail(f"fault envelope {sname}: a retried {domain} fault left {st['breaker']} "
                 f"{lane_stats(st)}")
        log(f"fault envelope {sname}: one-shot {domain} exception retried "
            f"({st['n_retries']:.0f} retries, {wall * 1e3:.3f} ms); reply byte-identical to "
            "TorchEngine(cpu); breakers closed")
    # 2. a persistent exception exhausts the envelope launch by launch
    threshold = dispatch.threshold
    honey_badger.set_exception(faults.MODULE, faults.DEVICE_DISPATCH)
    total = failures_total()
    t0 = time.perf_counter()
    n = 0
    while dispatch.state != "open":
        n += 1
        if n > threshold:
            fail(f"fault envelope {sname}: the breaker did not open in {threshold} launches")
        reply, _ = one_tick(eng, req)
        if any(it.batches for it in reply.items) or reply.deregistered:
            fail(f"fault envelope {sname}: an exhausted launch did not end in skip_on_failure")
    t_open = time.perf_counter()
    t_trip = t_open - t0
    if failures_total() != total + n:
        fail(f"fault envelope {sname}: {n} exhausted launches made "
             f"{failures_total() - total:.0f} samples of coproc_failures_total")
    dereg = TorchEngine(device=dev, **PIN_K1, row_stride=ROW_STRIDE, host_workers=0)
    dereg.enable_coprocessors([(1, spec.to_json(), ("bench",), ErrorPolicy.deregister)])
    reply, _ = one_tick(dereg, req)
    if reply.deregistered != [1] or dereg.heartbeat() != 0:
        fail(f"fault envelope {sname}: an exhausted launch did not deregister its script")
    dereg.shutdown()
    # 3. the open breaker refuses the next launch: no kernel launch
    st0, before = eng.stats(), kernel.launches
    refused = probes.coproc_failure_counter("dispatch", "DeviceUnavailable").value
    reply, t_refused = one_tick(eng, req)
    st1 = eng.stats()
    key = f"n_kernel_{kernel.name}"
    if (kernel.launches != before or st1.get(key) != st0.get(key)
            or any(it.batches for it in reply.items)
            or probes.coproc_failure_counter("dispatch", "DeviceUnavailable").value != refused + 1):
        fail(f"fault envelope {sname}: the open breaker let a launch through "
             f"({kernel.launches - before} launches, {lane_stats(st1)})")
    # 4. after the cooldown the half-open probe launches once and closes it
    honey_badger.unset(faults.MODULE, faults.DEVICE_DISPATCH)
    t0 = time.perf_counter()
    while dispatch.state == "open":
        if time.perf_counter() - t0 > 5.0:
            fail(f"fault envelope {sname}: the breaker stayed open past its cooldown")
        time.sleep(0.005)
    before = kernel.launches
    reply, _ = one_tick(eng, req)
    t_closed = time.perf_counter()
    t_recover = t_closed - t0
    if reply_bytes(reply) != want or kernel.launches - before != 1 or dispatch.state != "closed":
        fail(f"fault envelope {sname}: the half-open probe made {kernel.launches - before} "
             f"launches, breaker {dispatch.snapshot()}")
    if reply_bytes(one_tick(eng, req)[0]) != want:
        fail(f"fault envelope {sname}: the reply after recovery differs")
    # 6. the journal holds each transition as a consistent pair
    entries = [e for e in reversed(governor.journal.entries(domain=governor.BREAKER))
               if e.get("engine") == eng.governor.engine_tag]
    last: dict = {}
    for e in entries:
        b, frm, to = e["inputs"]["breaker"], e["inputs"]["from"], e["verdict"]
        if not e["reason"].startswith(f"{b}: {frm} -> {to}") or last.get(b, "closed") != frm:
            fail(f"fault envelope {sname}: an inconsistent journal entry {e}")
        last[b] = to
    pairs = [(e["inputs"]["from"], e["verdict"]) for e in entries
             if e["inputs"]["breaker"] == faults.DEVICE_DISPATCH]
    if pairs != [("closed", "open"), ("open", "half_open"), ("half_open", "closed")]:
        fail(f"fault envelope {sname}: dispatch breaker transitions {pairs}")
    st = eng.stats()
    eng.shutdown()
    log(f"fault envelope {sname}: a persistent dispatch exception tripped the breaker "
        f"(threshold {threshold}) after {n} exhausted launches in {t_trip * 1e3:.3f} ms; "
        f"the open breaker refused a launch in {t_refused * 1e3:.3f} ms with no "
        f"{kernel.name} launch; recovered (cooldown {FAULT_COOLDOWN_MS} ms, one half-open "
        f"probe launch) {(t_closed - t_open) * 1e3:.3f} ms after the breaker opened, "
        f"{t_recover * 1e3:.3f} ms after the fault was disarmed; journal "
        f"{pairs}; breaker {json.dumps(st['breaker'])}; dispatch envelope bound "
        f"{eng.governor.envelope_bound_s(faults.DEVICE_DISPATCH):.3f} s")


def probe_keeps_no_stats(dev, req) -> None:
    """The pool probe's passes on the card, whose device legs run on fetch
    workers: they leave the engine's stats alone (no kernel count, dispatch
    or device time, link bytes), as on the CPU, while their launches are
    real and count on the kernels."""
    from redpanda_tpu_torch import kernels
    from redpanda_tpu_torch.coproc import engine as engine_mod
    from redpanda_tpu_torch.coproc.engine import ErrorPolicy, TorchEngine

    batches = [b for it in req.items for b in it.batches]
    counts = [b.header.record_count for b in batches]
    for sname, spec, kernel in (("columnar", columnar_spec(), kernels.PREDICATE),
                                ("payload", payload_spec(), kernels.PAYLOAD_TRANSFORM)):
        eng = TorchEngine(device=dev, **PIN_K1, row_stride=ROW_STRIDE, host_workers=4,
                          host_pool_probe=False)
        eng.enable_coprocessors([(1, spec.to_json(), ("bench",))])
        run_stream(eng, req, 2)  # warm-up
        before, n0 = eng.stats(), kernel.launches
        launch = engine_mod._Launch(eng, 1, ErrorPolicy.skip_on_failure, eng._plans[1])
        t_inline, t_sharded = eng._measure_pool_ratio(launch, batches, counts)
        after = eng.stats()
        eng.shutdown()
        after.pop("arena"), before.pop("arena")  # the framing arena counts its buffers
        moved = {k: (before.get(k), after.get(k)) for k in set(before) | set(after)
                 if before.get(k) != after.get(k)}
        if moved or kernel.launches == n0:
            fail(f"pool probe {sname}: the probe's passes moved the engine's stats {moved} "
                 f"({kernel.launches - n0} {kernel.name} launches)")
        log(f"pool probe {sname} on the card: inline {t_inline * 1e3:.3f} ms, sharded "
            f"{t_sharded * 1e3:.3f} ms, {kernel.launches - n0} {kernel.name} launches on "
            "fetch workers; the engine's stats unchanged")


def hop_lanes(dev, engine_run, rounds: int = 2) -> None:
    """What the fault envelope's hop to a fetch worker costs: the default
    columnar and payload engines with their device legs on fetch workers
    (as shipped) and inline on the calling thread (no deadline), in turns
    (worker, inline, inline, worker), each over TICKS ticks of the bench
    workload, replies compared with the CPU engine's; t_leg_hop is the
    legs' hand-offs summed over the window, two legs a kernel launch (the
    launch and its copy down)."""
    from redpanda_tpu_torch.coproc.engine import TorchEngine

    work, want = engine_run["work"], engine_run["want"]
    for sname, spec, key in (("columnar", columnar_spec, "n_kernel_predicate"),
                             ("payload", payload_spec, "n_kernel_payload_transform")):
        for r in range(rounds):
            for legs in (("worker", "inline") if r % 2 == 0 else ("inline", "worker")):
                eng = TorchEngine(device=dev, **PIN_K1, row_stride=ROW_STRIDE)
                eng._leg_deadlines = legs == "worker"
                eng.enable_coprocessors([(1, spec().to_json(), ("bench",))])
                run_stream(eng, work["bench"], GROUP + 1)  # warm-up (and the pool probe)
                eng.reset_stats()
                replies, rate = run_stream(eng, work["bench"], TICKS)
                st = eng.stats()
                eng.shutdown()
                if any(reply_bytes(x) != want[sname, "bench"][k % GROUP]
                       for k, x in enumerate(replies)):
                    fail(f"hop lanes {sname} {legs}: a reply differs from the CPU engine's")
                check_envelope(f"hop lanes {sname} {legs}", st)
                hop, n_legs = st.get("t_leg_hop", 0.0), 2 * st[key]
                log(f"hop lanes {sname}, legs {legs} #{r + 1}, {TICKS} ticks: {rate:.1f} "
                    f"record_batches/s; t_leg_hop {hop:.6f} s over {n_legs:.0f} legs "
                    f"({hop / n_legs * 1e6:.1f} us a leg) of {st['n_launches']:.0f} launches; "
                    f"t_dispatch {st.get('t_dispatch', 0.0):.6f} t_harvest_wait "
                    f"{st.get('t_harvest_wait', 0.0):.6f} t_fetch {st.get('t_fetch', 0.0):.6f}; "
                    f"copy-up interval t_dev_h2d {st.get('t_dev_h2d', 0.0):.6f} s, of which "
                    f"the host's enqueue t_h2d_enqueue {st.get('t_h2d_enqueue', 0.0):.6f} s")


def wedge_lane(dev, req, want) -> None:
    """Phase 3g's wedge: a dispatch leg wedged past its deadline is
    abandoned on every attempt and the tick returns inside the envelope."""
    from redpanda_tpu_torch.coproc import faults
    from redpanda_tpu_torch.coproc.engine import TorchEngine
    from redpanda_tpu_torch.finjector import honey_badger
    from redpanda_tpu_torch.observability import probes

    # inline and a fixed deadline: one envelope per tick, none raised
    eng = TorchEngine(device=dev, **PIN_K1, row_stride=ROW_STRIDE, host_workers=0,
                      device_deadline_ms=WEDGE_DEADLINE_MS, adaptive_deadline=False)
    eng.enable_coprocessors([(1, columnar_spec().to_json(), ("bench",))])
    run_stream(eng, req, 2)  # warm-up
    reply, t_clean = one_tick(eng, req)
    if reply_bytes(reply) != want:
        fail("fault envelope wedge: the clean tick's reply differs")
    eng.reset_stats()
    bound = eng.governor.envelope_bound_s(faults.DEVICE_DISPATCH)
    deadlines = probes.coproc_failure_counter(faults.DEVICE_DISPATCH, "deadline").value
    total = failures_total()
    saved, honey_badger.wedge_max_s = honey_badger.wedge_max_s, 10.0
    honey_badger.set_wedge(faults.MODULE, faults.DEVICE_DISPATCH)
    try:
        reply, t_wedged = one_tick(eng, req)
    finally:
        honey_badger.unset(faults.MODULE, faults.DEVICE_DISPATCH)
        honey_badger.wedge_max_s = saved
    st = eng.stats()
    # the abandoned attempts run on once unwedged: let them end (they launch
    # K1 late) before any later phase counts its launches
    t0 = time.perf_counter()
    while faults.fetch_pool_stats()["free"] < faults.fetch_pool_stats()["created"]:
        if time.perf_counter() - t0 > 10.0:
            fail("fault envelope wedge: abandoned attempts did not end")
        time.sleep(0.005)
    eng.shutdown()
    if (any(it.batches for it in reply.items) or st.get("n_failures_dispatch") != 1
            or probes.coproc_failure_counter(faults.DEVICE_DISPATCH, "deadline").value
            != deadlines + 1 or failures_total() != total + 1):
        fail(f"fault envelope wedge: not a DeadlineExceeded into the policy {lane_stats(st)}")
    if t_wedged > bound + t_clean:
        fail(f"fault envelope wedge: the tick took {t_wedged:.3f} s against an envelope bound "
             f"of {bound:.3f} s and a clean tick of {t_clean:.3f} s")
    log(f"fault envelope wedge: a dispatch leg wedged past device_deadline_ms="
        f"{WEDGE_DEADLINE_MS} raised DeadlineExceeded into the policy after "
        f"{st.get('n_retries', 0):.0f} retries; tick {t_wedged * 1e3:.3f} ms against the "
        f"envelope bound {bound * 1e3:.3f} ms (+ a clean tick's {t_clean * 1e3:.3f} ms)")


def phase_columnar_backend(dev, engine_run) -> int:
    """Phase 3i: the process-wide columnar backend probe on the card, then
    the two halves the probe weighs (module docstring). Returns the phase's
    K1 launches (the probe's among them)."""
    from redpanda_tpu_torch import kernels
    from redpanda_tpu_torch.coproc import governor
    from redpanda_tpu_torch.coproc.engine import TorchEngine

    work, want = engine_run["work"], engine_run["want"]
    kernels.reset_launches()  # the probe's path starts here

    def probe(label: str, k: int):
        """A fresh unpinned engine whose first launch is k bench requests:
        it probes. Returns the engine and its verdict."""
        TorchEngine.reset_columnar_probe()
        n0 = kernels.PREDICATE.launches
        eng = TorchEngine(device=dev, row_stride=ROW_STRIDE)  # unpinned: it probes
        if eng.enable_coprocessors([(1, columnar_spec().to_json(), ("bench",))]) != [0]:
            fail("columnar backend: enable")
        replies = [t.result() for t in eng.submit_group([work["bench"]] * k)]
        if any(reply_bytes(r) != want["columnar", "bench"][j] for j, r in enumerate(replies)):
            fail(f"columnar backend: the probing launch's replies ({label}) differ from the "
                 "CPU engine's")
        st = eng.stats()
        backend, rec = st.get("columnar_backend"), st.get("columnar_probe")
        probe_k1 = kernels.PREDICATE.launches - n0 - st.get("n_kernel_predicate", 0)
        if backend not in ("host", "device") or probe_k1 != 2:
            fail(f"columnar backend: no verdict after a {label} launch ({backend}, {rec}, "
                 f"{probe_k1} probe launches)")
        mine = [e for e in governor.journal.entries() if e["domain"] == governor.COLUMNAR_BACKEND
                and e["engine"] == eng.governor.engine_tag]
        if len(mine) != 1 or mine[0]["inputs"] != rec or mine[0]["verdict"] != backend:
            fail(f"columnar backend: {len(mine)} COLUMNAR_BACKEND records, not one ({mine})")
        log(f"columnar backend probe on the card, first launch {label}: verdict {backend}; host "
            f"predicate t_host_s {rec['t_host_s']}, K1 launch + fetch t_device_s "
            f"{rec['t_device_s']} (the device must win {rec['margin']}x); {probe_k1} K1 "
            f"launches by the probe; one COLUMNAR_BACKEND record: {mine[0]['reason']}")
        return eng, backend

    # one bench request (2048 rows), then a full group as the lane sends it
    # (GROUP x 2048 rows), whose verdict the default lane then follows
    eng, _ = probe("of one request (2048 rows)", 1)
    eng.shutdown()
    eng, backend = probe(f"of a group ({GROUP} x 2048 rows)", GROUP)
    run_stream(eng, work["bench"], GROUP + 1)  # warm-up (and the pool probe), as every lane
    eng.reset_stats()
    rates, st = drive_lane("columnar backend default", eng, work, want_of(want, "columnar"),
                           n_ticks_of)
    eng.shutdown()
    host_lane = backend == "host"
    if ("n_host_predicate" in st) != host_lane or ("n_kernel_predicate" in st) == host_lane:
        fail(f"columnar backend: the default lane did not follow its verdict {lane_stats(st)}")
    log(f"columnar backend default lane (verdict {backend}): bench {rates['bench']:.1f} "
        f"record_batches/s over {TICKS} ticks, short_msgs {rates['short_msgs']:.1f}; replies "
        f"byte-identical to TorchEngine(cpu)")
    # the two halves, each pinned on its own engine, in turns (bench.py's
    # halves), both inline so that they differ in the predicate alone
    for i, mode in enumerate(("columnar_host", "columnar_device") * 2):
        eng = TorchEngine(device=dev, row_stride=ROW_STRIDE, force_mode=mode, host_workers=0)
        eng.enable_coprocessors([(1, columnar_spec().to_json(), ("bench",))])
        run_stream(eng, work["bench"], GROUP + 1)  # warm-up
        eng.reset_stats()
        n0 = kernels.PREDICATE.launches
        rates, st = drive_lane(f"columnar backend {mode}", eng, work,
                               want_of(want, "columnar"), n_ticks_of)
        eng.shutdown()
        k1 = kernels.PREDICATE.launches - n0
        if mode == "columnar_host" and (k1 or st.get("bytes_h2d") or not st.get("n_host_predicate")):
            fail(f"columnar_host lane: {k1} K1 launches {lane_stats(st)}")
        if mode == "columnar_device" and (not k1 or "n_host_predicate" in st):
            fail(f"columnar_device lane: {k1} K1 launches {lane_stats(st)}")
        split = {k: round(st.get(k, 0.0), 6) for k in (
            "t_leg_hop", "t_harvest_wait", "t_fetch", "t_dev_h2d", "t_dev_kernel", "t_dev_d2h",
            "t_leg_enqueue")}
        log(f"columnar backend {mode} #{i // 2 + 1}: bench {rates['bench']:.1f} "
            f"record_batches/s over {TICKS} ticks, short_msgs {rates['short_msgs']:.1f}; "
            f"t_dispatch {st.get('t_dispatch', 0.0) + st.get('t_shard_dispatch', 0.0):.6f} s "
            f"beside the stages {json.dumps(split)} (bench workload); "
            f"K1 launches {k1}, host predicates {st.get('n_host_predicate', 0):.0f}, "
            f"{st['n_launches']:.0f} launches")
    TorchEngine.reset_columnar_probe()
    return path_launches("columnar backend", kernels.PREDICATE)["predicate"]


RECORDER_PROBES = ("device_dispatch", "mask_fetch", "harvest", "shard_worker")


def recorder_lanes(dev, engine_run, on: bool, faults_too: bool) -> dict:
    """One round of phase 3j: the columnar (K1 pinned) and payload specs,
    inline and on the pool, each engine with a budget plane that never
    sheds, built after the recorders were turned on or off. Every reply is
    compared with the CPU engine's. With ``faults_too`` each engine then
    takes a one-shot fault on each coproc probe point. Returns
    {(spec, lane, workload): (rate, reply bytes)}."""
    from redpanda_tpu_torch.coproc import faults, leakwatch, lockwatch
    from redpanda_tpu_torch.coproc.engine import TorchEngine
    from redpanda_tpu_torch.finjector import honey_badger
    from redpanda_tpu_torch.resource_mgmt import BudgetPlane

    work, want = engine_run["work"], engine_run["want"]
    out = {}
    for sname, spec in (("columnar", columnar_spec()), ("payload", payload_spec())):
        for lane, kw in (("inline", dict(host_workers=0)),
                         ("pool", dict(host_workers=4, host_pool_probe=False))):
            plane = BudgetPlane(ADMIT_NEVER_SHEDS)
            eng = TorchEngine(device=dev, **PIN_K1, row_stride=ROW_STRIDE, budget_plane=plane,
                              **kw)
            wrapped = isinstance(eng._stats_lock, lockwatch.WatchedLock) and isinstance(
                eng._arena, leakwatch.WatchedArena)
            if wrapped != on:
                fail(f"recorders {sname} {lane}: wrapped {wrapped} with the recorders on={on}")
            eng.enable_coprocessors([(1, spec.to_json(), ("bench",))])
            run_stream(eng, work["bench"], GROUP + 1)  # warm-up
            eng.reset_stats()
            for wname, req in work.items():
                replies, rate = run_stream(eng, req, n_ticks_of(wname))
                got = [reply_bytes(x) for x in replies[:GROUP]]
                if any(reply_bytes(x) != want[sname, wname][k % GROUP]
                       for k, x in enumerate(replies)):
                    fail(f"recorders on={on} {sname} {lane} {wname}: a reply differs from the "
                         "CPU engine's")
                out[sname, lane, wname] = (rate, got)
            check_envelope(f"recorders on={on} {sname} {lane}", eng.stats())
            if faults_too:
                req, ref = work["short_msgs"], want[sname, "short_msgs"][0]
                honey_badger.enable()
                try:
                    for probe in RECORDER_PROBES:
                        if probe == faults.MASK_FETCH:
                            eng._harvest_async = lambda: False  # the caller fetches its masks
                        honey_badger.set_exception(faults.MODULE, probe, count=1)
                        try:
                            reply, _ = one_tick(eng, req)
                        finally:
                            honey_badger.unset(faults.MODULE, probe)
                            eng.__dict__.pop("_harvest_async", None)
                        if reply_bytes(reply) != ref:
                            fail(f"recorders {sname} {lane}: a one-shot {probe} fault changed "
                                 "the reply")
                finally:
                    honey_badger.disable()
                st = eng.stats()
                if on and (st["lockwatch"]["edges"] != len(lockwatch.edges())
                           or st["leakwatch"]["imbalances"]):
                    fail(f"recorders {sname} {lane}: stats {st['lockwatch']} {st['leakwatch']}")
            eng.shutdown()
            if plane.account("coproc").held:
                fail(f"recorders {sname} {lane}: {plane.account('coproc').held} B still held")
    return out


def phase_recorders(dev, engine_run) -> dict:
    """Phase 3j: lockwatch and leakwatch on the card (module docstring).
    Returns the path's K1 and K4 launches."""
    import ast

    from redpanda_tpu_torch import kernels
    from redpanda_tpu_torch.coproc import faults, leakwatch, lockwatch

    kernels.reset_launches()  # the recorders' path starts here
    lockwatch.reset_edges()
    leakwatch.reset()
    rounds = []
    try:
        for i, on in enumerate((True, False, True, False)):
            if on:
                lockwatch.enable()
                leakwatch.enable()
            try:
                rounds.append((on, recorder_lanes(dev, engine_run, on, faults_too=i == 0)))
            finally:
                lockwatch.disable()
                leakwatch.disable()
            while faults.fetch_pool_stats()["free"] < faults.fetch_pool_stats()["created"]:
                time.sleep(0.01)  # an abandoned leg must not launch into the next round
        launches = path_launches("recorders", kernels.PREDICATE, kernels.PAYLOAD_TRANSFORM)
        edges = lockwatch.edges()
        from tools.pandalint.affinity import Program
        from tools.pandalint.engine import iter_python_files
        from tools.pandalint.lockgraph import LockGraph

        root = os.path.dirname(os.path.abspath(__file__))
        mods = []
        for path in iter_python_files([os.path.join(root, "redpanda_tpu_torch")]):
            with open(path, encoding="utf-8") as fh:
                mods.append((os.path.relpath(path, root).replace(os.sep, "/"),
                             ast.parse(fh.read())))
        static = LockGraph(Program(mods)).edge_set()
        missing = [e for e in edges if e not in static]
        log(f"lockwatch on the card: {len(edges)} lock-order edges observed {edges}; subset of "
            f"pandalint's static graph over redpanda_tpu_torch/ ({len(static)} edges): "
            f"{not missing}")
        if not edges or missing:
            fail(f"lockwatch: edges the static graph lacks {missing} (observed {edges})")
        snap, bal = leakwatch.snapshot(), leakwatch.balances()
        log(f"leakwatch on the card: balances {json.dumps(bal)} (all zero: "
            f"{not any(bal.values())}); imbalances {snap['imbalances']}; "
            f"{snap['sites']} acquire/release sites")
        if not bal or any(bal.values()) or snap["imbalances"]:
            fail(f"leakwatch: balances {bal}, {snap}")
    finally:
        lockwatch.disable()
        leakwatch.disable()
        lockwatch.reset_edges()
        leakwatch.reset()
    (_, first_on), (_, first_off) = rounds[0], rounds[1]
    for key, (_, got) in first_on.items():
        if got != first_off[key][1]:
            fail(f"recorders: the {key} replies with the recorders on differ from those off")
    log("recorders: every reply with lockwatch and leakwatch on byte-identical to the same "
        "engines' with both off and to TorchEngine(cpu)'s; one-shot faults on "
        f"{', '.join(RECORDER_PROBES)} retried to the same replies; launches over the four "
        f"rounds {launches}")
    for sname in ("columnar", "payload"):
        for lane in ("inline", "pool"):
            turns = ", ".join(f"{'on' if on else 'off'} {r[sname, lane, 'bench'][0]:.1f}"
                              for on, r in rounds)
            log(f"recorders cost, {sname} {lane} lane, bench record_batches/s over {TICKS} "
                f"ticks in turns: {turns} (a cost figure, not a claim)")
    return launches


SANDBOX_SOURCE = (
    "def transform(value):\n"
    "    if b'\"level\":\"error\"' not in value:\n"
    "        return None\n"
    "    return value.upper()\n")
SANDBOX_BURN = "def transform(value):\n    x = 10 ** 10 ** 8\n    return value\n"


def phase_sandbox(dev, engine_run) -> None:
    """Phase 3k: a sandboxed python transform over the bench launch on the
    card's engine, inline and on the default probed pool (module
    docstring)."""
    from redpanda_tpu_torch.coproc import governor
    from redpanda_tpu_torch.coproc.engine import (ErrorPolicy, ProcessBatchItem,
                                                  ProcessBatchRequest, TorchEngine)

    work = engine_run["work"]
    cpu = TorchEngine(device="cpu", row_stride=ROW_STRIDE, host_workers=0)
    if cpu.enable_py_sandboxed(1, SANDBOX_SOURCE, ("bench",)) != 0:
        fail("sandbox: enable on the CPU engine")
    want = {w: [reply_bytes(t.result()) for t in cpu.submit_group([req] * GROUP)]
            for w, req in work.items()}
    cpu.shutdown()
    kept = sum(len(b) for _, _, b in want["bench"][0][0])
    if not kept:
        fail("sandbox: the transform kept no record")

    def kills() -> list:
        return [e for e in governor.journal.entries(domain=governor.TREND)
                if e["verdict"] == "watchdog_kill"]

    for lane, kw in (("inline", dict(host_workers=0)), ("probed pool", dict(host_workers=4))):
        eng = TorchEngine(device=dev, **PIN_K1, row_stride=ROW_STRIDE, **kw)
        if eng.enable_py_sandboxed(1, SANDBOX_SOURCE, ("bench",)) != 0:
            fail(f"sandbox {lane}: enable on the card's engine")
        calls = [0]

        def count(value, calls=calls):
            calls[0] += 1
            return value

        if eng.enable_py_transform(3, count, ("bench",)) != 0:
            fail(f"sandbox {lane}: enable the counting callable")
        rates = {}
        for wname, req in work.items():
            replies, rates[wname] = run_stream(eng, req, GROUP)
            if [reply_bytes(x) for x in replies] != want[wname]:
                fail(f"sandbox {lane} {wname}: a reply differs from TorchEngine(cpu)'s")
        # the callable runs once a record of the launch, the pool probe's
        # passes included
        req = work["bench"]
        counted = ProcessBatchRequest([ProcessBatchItem(3, it.ntp, it.batches)
                                       for it in req.items])
        n_records = GROUP * sum(b.header.record_count for it in req.items for b in it.batches)
        for t in eng.submit_group([counted] * GROUP):
            t.result()
        if calls[0] != n_records:
            fail(f"sandbox {lane}: the callable ran {calls[0]} times over {n_records} records")
        st = eng.stats()
        check_envelope(f"sandbox {lane}", st)
        probe = st.get("host_pool_probe")
        if kw["host_workers"] and (probe is None or probe["chosen"] != eng._pool_decision):
            fail(f"sandbox {lane}: the pool decision was not measured: {probe}")
        seen = {e["seq"] for e in kills()}
        if eng.enable_py_sandboxed(2, SANDBOX_BURN, ("bench",), ErrorPolicy.deregister) != 0:
            fail(f"sandbox {lane}: enable the burning script")
        burn = ProcessBatchRequest([ProcessBatchItem(2, it.ntp, it.batches)
                                    for it in work["short_msgs"].items])
        t0 = time.perf_counter()
        reply = eng.submit_group([burn])[0].result()
        wall = time.perf_counter() - t0
        new_kills = [e for e in kills() if e["seq"] not in seen]
        if reply.deregistered != [2] or 2 in eng.scripts or len(new_kills) != 1 \
                or new_kills[0]["inputs"]["layer"] != "guard":
            fail(f"sandbox {lane}: the guard kill under deregister gave {reply.deregistered}, "
                 f"scripts {sorted(eng.scripts)}, kills {new_kills}")
        after = eng.stats()
        if "n_failures_pool_calibration" in after or \
                after.get("host_pool_probe") != st.get("host_pool_probe"):
            fail(f"sandbox {lane}: the guard kill reached the pool's decision: "
                 f"{after.get('host_pool_probe')} after {st.get('host_pool_probe')}")
        eng.shutdown()
        log(f"sandbox on the card's engine, {lane} (host_workers {kw['host_workers']}): the "
            f"bench launch ({GROUP} x {len(work['bench'].items)} batches) through a sandboxed "
            f"transform keeping the error records upper-cased: bench {rates['bench']:.1f} "
            f"record_batches/s, short_msgs {rates['short_msgs']:.1f} over {GROUP} ticks (one "
            f"launch each), {kept} output batches a tick, replies byte-identical to "
            f"TorchEngine(cpu)'s; t_assemble {st.get('t_assemble', 0.0):.6f} s of "
            f"{st['n_records']:.0f} records; a counting callable ran {calls[0]} times over "
            f"{n_records} records; pool probe {json.dumps(probe)}; a guard kill "
            f"(10 ** 10 ** 8) under deregister in {wall * 1e3:.3f} ms deregistered script "
            f"{reply.deregistered} with one TREND watchdog_kill "
            f"({new_kills[0]['inputs']['layer']})")


def want_of(want: dict, sname: str) -> dict:
    return {w: r for (s, w), r in want.items() if s == sname}


def n_ticks_of(wname: str) -> int:
    return TICKS if wname == "bench" else 2 * GROUP


ADMIT_NEVER_SHEDS = 1 << 40  # a plane whose coproc account (256 GiB) never fills


def phase_admission(dev, engine_run) -> dict:
    """Phase 3h: the budget plane and admission on the card (module
    docstring). Returns the path's K1 and K4 launches."""
    from redpanda_tpu_torch import kernels

    kernels.reset_launches()  # the admission path starts here
    for sname, spec, kernel in (("columnar", columnar_spec(), kernels.PREDICATE),
                                ("payload", payload_spec(), kernels.PAYLOAD_TRANSFORM)):
        admission_flood(dev, sname, spec, kernel, engine_run)
    admission_parity(dev, engine_run)
    admission_faults(dev, engine_run)
    admission_pressure(dev, engine_run)
    admission_cost(dev, engine_run)
    return path_launches("admission", kernels.PREDICATE, kernels.PAYLOAD_TRANSFORM)


def admission_journal(eng) -> list:
    """The engine's ADMISSION journal entries, oldest first."""
    from redpanda_tpu_torch.coproc import governor

    return [e for e in reversed(governor.journal.entries(domain=governor.ADMISSION))
            if e.get("engine") == eng.governor.engine_tag]


def admission_flood(dev, sname, spec, kernel, engine_run) -> None:
    """3h (a): groups submitted without harvesting on the reference's
    default plane shed exactly where the group's bytes say, with nothing
    run; the harvests that free enough bytes admit the next group."""
    import math

    from redpanda_tpu_torch import kernels
    from redpanda_tpu_torch.coproc.engine import TorchEngine
    from redpanda_tpu_torch.resource_mgmt import BudgetPlane, ShedError

    req = engine_run["work"]["bench"]
    want = engine_run["want"][sname, "bench"]
    plane = BudgetPlane()  # 512 MiB, coproc 128 MiB
    acct = plane.account("coproc")
    r = sum(len(b.payload) for it in req.items for b in it.batches)
    group = GROUP * r
    k_pred = acct.limit // group  # the first group the account cannot hold
    m_pred = math.ceil((group - (acct.limit - k_pred * group)) / r)  # harvests to admit it
    log(f"admission flood {sname}: a request reserves {r} B, a group of {GROUP} {group} B, the "
        f"coproc account {acct.limit} B: predicted first shed at group {k_pred} (0-based), "
        f"admitted again after {m_pred} harvested tickets")
    eng = TorchEngine(device=dev, **PIN_K1, row_stride=ROW_STRIDE, budget_plane=plane)
    try:
        if eng.enable_coprocessors([(1, spec.to_json(), ("bench",))]) != [0]:
            fail(f"admission flood: enable {sname}")
        outstanding = []
        g = 0
        while True:
            before = (kernels.PREDICATE.launches, kernels.PAYLOAD_TRANSFORM.launches)
            st0, held0 = eng.stats(), acct.held
            try:
                outstanding.extend(eng.submit_group([req] * GROUP))
            except ShedError as exc:
                shed_exc = exc
                break
            g += 1
            if g > k_pred:
                fail(f"admission flood {sname}: group {g - 1} admitted past the prediction")
        st1 = eng.stats()
        launched = (kernels.PREDICATE.launches, kernels.PAYLOAD_TRANSFORM.launches)
        if g != k_pred:
            fail(f"admission flood {sname}: the first shed came at group {g}, predicted {k_pred}")
        if (launched != before or st1.get("bytes_h2d") != st0.get("bytes_h2d")
                or acct.held != held0 or acct.held != k_pred * group
                or st1.get(f"n_kernel_{kernel.name}") != st0.get(f"n_kernel_{kernel.name}")):
            fail(f"admission flood {sname}: the shed submit ran something: launches {before} -> "
                 f"{launched}, bytes_h2d {st0.get('bytes_h2d')} -> {st1.get('bytes_h2d')}, held "
                 f"{held0} -> {acct.held}")
        log(f"admission flood {sname}: shed at group {g} as predicted ({shed_exc}); the shed "
            f"submit made 0 K1/K4 launches and 0 B H2D, held {acct.held} B unchanged")
        # harvest the oldest tickets one by one, retrying the next group after each
        harvested = 0
        while True:
            reply = outstanding.pop(0).result()
            if reply_bytes(reply) != want[harvested % GROUP]:
                fail(f"admission flood {sname}: harvested reply {harvested} differs")
            harvested += 1
            try:
                outstanding.extend(eng.submit_group([req] * GROUP))
                break
            except ShedError:
                if harvested >= m_pred:
                    fail(f"admission flood {sname}: still shedding after {harvested} harvests")
        if harvested != m_pred:
            fail(f"admission flood {sname}: admitted after {harvested} harvests, predicted "
                 f"{m_pred}")
        for t in outstanding:
            if reply_bytes(t.result()) != want[0]:
                fail(f"admission flood {sname}: a reply after the flood differs")
        st = eng.stats()
        verdicts = [e["verdict"] for e in admission_journal(eng)]
        if acct.held != 0 or verdicts.count("shed") != 1 or verdicts.count("resumed") != 1:
            fail(f"admission flood {sname}: held {acct.held}, journal {verdicts}")
        check_envelope(f"admission flood {sname}", st)
        log(f"admission flood {sname}: the next group admitted after {harvested} harvested "
            f"tickets as predicted; held 0 after every ticket harvested; {st['n_shed_submits']:.0f} "
            f"shed submits, journal {verdicts}; admission {json.dumps(st['admission'])}")
    finally:
        eng.shutdown()


def admission_parity(dev, engine_run) -> None:
    """3h (b): an engine whose plane never sheds replies byte for byte as a
    plane-less engine and the CPU engine, on the columnar and payload lanes."""
    from redpanda_tpu_torch.coproc.engine import TorchEngine
    from redpanda_tpu_torch.resource_mgmt import BudgetPlane

    work, want = engine_run["work"], engine_run["want"]
    for sname, spec in (("columnar", columnar_spec()), ("payload", payload_spec())):
        got = {}
        for label, plane in (("plane", BudgetPlane(ADMIT_NEVER_SHEDS)), ("plane-less", None)):
            eng = TorchEngine(device=dev, **PIN_K1, row_stride=ROW_STRIDE, budget_plane=plane)
            eng.enable_coprocessors([(1, spec.to_json(), ("bench",))])
            for wname, req in work.items():
                replies, _ = run_stream(eng, req, 2 * GROUP)
                got[label, wname] = [reply_bytes(x) for x in replies]
                if any(x != want[sname, wname][k % GROUP]
                       for k, x in enumerate(got[label, wname])):
                    fail(f"admission parity {sname} {label} {wname}: a reply differs from the "
                         "CPU engine's")
            st = eng.stats()
            eng.shutdown()
            check_envelope(f"admission parity {sname} {label}", st)
            if plane is not None and (plane.account("coproc").held != 0
                                      or st.get("n_shed_submits")):
                fail(f"admission parity {sname}: {st.get('admission')}")
        if any(got["plane", w] != got["plane-less", w] for w in work):
            fail(f"admission parity {sname}: the planed engine's replies differ")
    log("admission parity: with a plane that never sheds, every reply of the columnar and "
        "payload lanes byte-identical to a plane-less engine's and to TorchEngine(cpu)'s")


def admission_faults(dev, engine_run) -> None:
    """3h (c): a persistent dispatch fault and a persistent harvest fault,
    armed through the honey badger, each leave the account empty after
    they raise into the script's error policy."""
    from redpanda_tpu_torch.coproc import faults
    from redpanda_tpu_torch.coproc.engine import TorchEngine
    from redpanda_tpu_torch.finjector import honey_badger
    from redpanda_tpu_torch.resource_mgmt import BudgetPlane

    req = engine_run["work"]["short_msgs"]
    out = []
    honey_badger.enable()
    try:
        for domain in (faults.DEVICE_DISPATCH, faults.HARVEST):
            plane = BudgetPlane()
            acct = plane.account("coproc")
            eng = TorchEngine(device=dev, **PIN_K1, row_stride=ROW_STRIDE, budget_plane=plane,
                              retry_backoff_ms=1)
            eng.enable_coprocessors([(1, columnar_spec().to_json(), ("bench",))])
            run_stream(eng, req, 2)  # warm-up: the probes decide before the fault
            honey_badger.set_exception(faults.MODULE, domain)
            try:
                tickets = eng.submit_group([req] * 2)
                held = acct.held
                replies = [t.result() for t in tickets]
            finally:
                honey_badger.unset(faults.MODULE, domain)
            st = eng.stats()
            eng.shutdown()
            failures = {k: v for k, v in st.items() if k.startswith("n_failures")}
            if (acct.held != 0 or held == 0 or not failures
                    or any(it.batches for x in replies for it in x.items)):
                fail(f"admission faults {domain}: held {acct.held} (in flight {held}), failures "
                     f"{failures}")
            out.append(f"{domain}: {held} B held in flight, 0 after the raise, {json.dumps(failures)}")
    finally:
        for module, armed in list(honey_badger.armed().items()):
            for probe in armed:
                honey_badger.unset(module, probe)
        honey_badger.disable()
    log("admission faults (persistent, into skip_on_failure): " + "; ".join(out))


def admission_pressure(dev, engine_run) -> None:
    """3h (d): occupancy pushed over 0.90 through the plane's own storage
    account evicts the column cache to half its budget and frees the
    evicted entries' CUDA tensors; the evicted window then misses and
    launches K1 with its copy up; back at ok the whole budget returns."""
    import torch

    from redpanda_tpu_torch import kernels
    from redpanda_tpu_torch.coproc import colcache
    from redpanda_tpu_torch.coproc.engine import TorchEngine
    from redpanda_tpu_torch.resource_mgmt import BudgetPlane

    work, want = engine_run["work"], engine_run["want"]
    # each submit's cache key: the launch's batches, request by request
    keys = {w: (1, colcache.fingerprint([b for _ in range(GROUP) for it in req.items
                                         for b in it.batches])) for w, req in work.items()}

    def fill(eng):
        for wname, req in work.items():  # two submits, one cold launch each
            for k, t in enumerate(eng.submit_group([req] * GROUP)):
                if reply_bytes(t.result()) != want["columnar", wname][k]:
                    fail(f"admission pressure {wname}: a reply differs from the CPU engine's")

    # the two entries' bytes, on an engine whose cache holds both at ease
    probe = TorchEngine(device=dev, **PIN_K1, row_stride=ROW_STRIDE, host_workers=0,
                        device_column_cache_mb=256)
    probe.enable_coprocessors([(1, columnar_spec().to_json(), ("bench",))])
    fill(probe)
    two = probe.stats()["colcache"]["bytes"]
    probe.shutdown()
    del probe
    budget_mb = -(-two // (1 << 20))  # holds both; the halved budget holds one
    plane = BudgetPlane()
    eng = TorchEngine(device=dev, **PIN_K1, row_stride=ROW_STRIDE, host_workers=0,
                      device_column_cache_mb=budget_mb, budget_plane=plane)
    try:
        eng.enable_coprocessors([(1, columnar_spec().to_json(), ("bench",))])
        fill(eng)
        cc = eng.stats()["colcache"]
        if cc["entries"] != 2 or cc["bytes"] <= cc["budget_bytes"] // 2:
            fail(f"admission pressure: the cache did not fill over two submits {cc}")
        torch.cuda.synchronize(dev)
        dev_bytes = {k: e.cols_dev.nbytes for k, e in
                     eng._colcache._entries.items() if e.cols_dev is not None}
        if set(dev_bytes) != set(keys.values()):
            fail("admission pressure: a cached entry holds no CUDA tensors")
        alloc0, reserved0 = torch.cuda.memory_allocated(dev), torch.cuda.memory_reserved(dev)
        storage = plane.account("storage")
        pushed = storage.try_acquire(int(storage.limit * 0.95))
        alloc1, reserved1 = torch.cuda.memory_allocated(dev), torch.cuda.memory_reserved(dev)
        st = eng.stats()
        cc = st["colcache"]
        evicted = set(dev_bytes) - set(eng._colcache._entries)
        freed = sum(dev_bytes[k] for k in evicted)
        if (plane.pressure() != "critical" or not evicted or cc["bytes"] > cc["budget_bytes"] // 2
                or st.get("n_pressure_evictions") != len(evicted)
                or st.get("n_pressure_trims") != 1):
            fail(f"admission pressure: critical did not evict to half the budget {cc} "
                 f"{lane_stats(st)}")
        if alloc0 - alloc1 < freed:
            fail(f"admission pressure: memory_allocated fell {alloc0 - alloc1} B, the evicted "
                 f"entries held {freed} B on the card")
        log(f"admission pressure: storage at {pushed / storage.limit:.4f} -> critical; the cache "
            f"({budget_mb} MiB) evicted {len(evicted)} of 2 entries to {cc['bytes']} B (half "
            f"budget {cc['budget_bytes'] // 2} B); memory_allocated {alloc0} -> {alloc1} B (fell "
            f"{alloc0 - alloc1} B, the evicted entries' CUDA tensors {freed} B); "
            f"memory_reserved {reserved0} -> {reserved1} B; arena {json.dumps(st['arena'])}")
        # the evicted window misses: the ladder, its copy up and K1 run again
        wname = next(w for w, key in keys.items() if key in evicted)
        before, k1 = eng.stats(), kernels.PREDICATE.launches
        for k, t in enumerate(eng.submit_group([work[wname]] * GROUP)):
            if reply_bytes(t.result()) != want["columnar", wname][k]:
                fail("admission pressure: the reply after the eviction differs")
        after = eng.stats()
        if (after["n_colcache_miss"] != before["n_colcache_miss"] + 1
                or kernels.PREDICATE.launches != k1 + 1
                or after.get("bytes_h2d", 0) <= before.get("bytes_h2d", 0)):
            fail(f"admission pressure: the evicted window did not miss and launch K1 "
                 f"{lane_stats(after)}")
        storage.release(pushed)
        cc = eng.stats()["colcache"]
        verdicts = [e["verdict"] for e in admission_journal(eng)]
        if (plane.pressure() != "ok" or cc["pressure"]
                or cc["effective_budget_bytes"] != cc["budget_bytes"]
                or verdicts != ["critical", "ok"]):
            fail(f"admission pressure: release did not restore ok and the budget {cc} {verdicts}")
        check_envelope("admission pressure", eng.stats())
        log(f"admission pressure: the evicted window ({wname}) missed, launched K1 once and "
            f"copied {after.get('bytes_h2d', 0) - before.get('bytes_h2d', 0):.0f} B up; release "
            f"-> ok, effective budget {cc['effective_budget_bytes']} B; journal {verdicts}")
    finally:
        eng.shutdown()


def admission_cost(dev, engine_run, rounds: int = 2) -> None:
    """3h (e): what admission costs on the default lanes: each spec with a
    plane that never sheds and without one, in turns (plane, none, none,
    plane), TICKS ticks of the bench workload each. Information, no gate."""
    from redpanda_tpu_torch.coproc.engine import TorchEngine
    from redpanda_tpu_torch.resource_mgmt import BudgetPlane

    work, want = engine_run["work"], engine_run["want"]
    for sname, spec in (("columnar", columnar_spec), ("payload", payload_spec)):
        for r in range(rounds):
            for label in (("plane", "none") if r % 2 == 0 else ("none", "plane")):
                plane = BudgetPlane(ADMIT_NEVER_SHEDS) if label == "plane" else None
                eng = TorchEngine(device=dev, **PIN_K1, row_stride=ROW_STRIDE, budget_plane=plane)
                eng.enable_coprocessors([(1, spec().to_json(), ("bench",))])
                run_stream(eng, work["bench"], GROUP + 1)  # warm-up (and the pool probe)
                eng.reset_stats()
                replies, rate = run_stream(eng, work["bench"], TICKS)
                st = eng.stats()
                eng.shutdown()
                if any(reply_bytes(x) != want[sname, "bench"][k % GROUP]
                       for k, x in enumerate(replies)):
                    fail(f"admission cost {sname} {label}: a reply differs from the CPU engine's")
                check_envelope(f"admission cost {sname} {label}", st)
                log(f"admission cost {sname}, {label} #{r + 1}, {TICKS} ticks: {rate:.1f} "
                    f"record_batches/s; n_shed_submits {st.get('n_shed_submits', 0):.0f}; "
                    f"admitted (warm-up included) {st.get('admission', {}).get('admitted', '-')}")


def phase_card_failures(dev, work) -> None:
    """Phase 3f: on the card nothing takes the place of a mask. A K1 launch
    that fails in every shard of a pool launch degrades it to the inline
    lane, whose launch fails too: the script's error policy drops (skip) or
    unloads (deregister) its output. A copy down that fails on the harvest
    thread is raised by Ticket.result into the same policy."""
    from redpanda_tpu_torch import kernels
    from redpanda_tpu_torch.coproc import engine as engine_mod
    from redpanda_tpu_torch.coproc.engine import ErrorPolicy, TorchEngine

    req = work["short_msgs"]  # a host mask would have kept records here

    def failing(*args):
        raise RuntimeError("injected failure")

    def run(policy):
        eng = TorchEngine(device=dev, **PIN_K1, row_stride=ROW_STRIDE, host_workers=4,
                          host_pool_probe=False)
        eng.enable_coprocessors([(1, columnar_spec().to_json(), ("bench",), policy)])
        reply = eng.submit_group([req] * 2)[0].result()  # 4096 records: four shards
        st = eng.stats()
        eng.shutdown()
        return reply, st

    cases = []
    for what in ("K1 launch", "harvest"):
        if what == "K1 launch":
            kernels.PREDICATE.launch = failing  # shadows the method on this one kernel
        else:
            real_wait, engine_mod._Pending.wait = engine_mod._Pending.wait, failing
        try:
            skip, st = run(ErrorPolicy.skip_on_failure)
            dereg, _ = run(ErrorPolicy.deregister)
        finally:
            if what == "K1 launch":
                del kernels.PREDICATE.launch
            else:
                engine_mod._Pending.wait = real_wait
        if any(it.batches for it in skip.items) or dereg.deregistered != [1]:
            fail(f"a failing {what}: output was kept ({len(skip.items)} items, deregistered "
                 f"{dereg.deregistered})")
        failures = {k: v for k, v in st.items() if k.startswith("n_failures")}
        want = ({"n_failures_shard_worker": 1.0, "n_failures_dispatch": 1.0} if what == "K1 launch"
                else {"n_failures_rebuild": 1.0})
        if any(failures.get(k) != v for k, v in want.items()) or (
                what == "harvest" and not failures.get("n_failures_harvest")):
            fail(f"a failing {what}: failures {failures}")
        cases.append(f"{what}: {json.dumps(failures)}")
    log("card failures (no host mask): every item of the skip script empty and the deregister "
        "script unloaded; " + "; ".join(cases))


def phase_policy(dev) -> int:
    """Phase 3d: the data policy's device leg over a fetch of the bench's
    partitions."""
    from redpanda_tpu_torch import kernels
    from redpanda_tpu_torch.policy import PolicyEngine

    spec = payload_spec().to_json()
    launches, kept = 0, 0
    for wname, short in (("bench", False), ("short_msgs", True)):
        batches = [b for it in build_request(short_msgs=short).items for b in it.batches]
        eng = PolicyEngine(device=dev)  # 2048 records: the device leg by its own rule
        eng.transform_batches(spec, batches)  # warm-up
        kernels.reset_launches()  # the policy's device leg starts here
        t0 = time.perf_counter()
        got = eng.transform_batches(spec, batches)
        ms = (time.perf_counter() - t0) * 1e3
        launches += path_launches("policy device leg",
                                  kernels.PAYLOAD_TRANSFORM)["payload_transform"]
        got = [b.encode_internal() for b in got]
        for leg in ("device", "host"):
            ref = PolicyEngine(device="cpu", force_engine=leg).transform_batches(spec, batches)
            if got != [b.encode_internal() for b in ref]:
                fail(f"policy {wname}: the card's view differs from the CPU {leg} leg's")
        kept += len(got)
        log(f"policy device leg {wname}: {len(batches)} batches, "
            f"{sum(b.header.record_count for b in batches)} records at row_stride 2048 in "
            f"{ms:.3f} ms host to host; view equal to the CPU device leg's and the host "
            f"evaluator's ({len(got)} batches)")
    if not kept:
        fail("policy: no view batch to compare")

    def failing(*args):
        raise RuntimeError("injected K4 launch failure")

    kernels.PAYLOAD_TRANSFORM.launch = failing  # shadows the method on this one kernel
    try:
        PolicyEngine(device=dev, force_engine="device").transform_batches(spec, batches)
    except RuntimeError as exc:
        log(f"policy: a failing K4 launch raises from transform_batches ({exc})")
    else:
        fail("policy: a failing K4 launch did not raise")
    finally:
        del kernels.PAYLOAD_TRANSFORM.launch
    return launches


# ------------------------------------------------------------------ CRC / LZ4 inputs
def produce_regions():
    """bench.py run_config1_crc_validate: 64 one-record batches of 1 KiB
    values, 16 times over: 1024 Kafka-CRC regions and their claimed CRCs."""
    import numpy as np

    from redpanda_tpu_torch.models import Record, RecordBatch

    batches = [RecordBatch.build([Record(offset_delta=0, value=bytes([0]) * 1024)], base_offset=b)
               for b in range(64)]
    batches = batches * (PRODUCE_BATCHES // len(batches))
    return [b.crc_region() for b in batches], np.array([b.header.crc for b in batches], np.uint32)


def random_batches(n: int, records: int, value: int, seed: int):
    import numpy as np

    from redpanda_tpu_torch.models import Record, RecordBatch

    rng = np.random.default_rng(seed)
    return [RecordBatch.build([Record(offset_delta=k, timestamp_delta=k, value=rng.bytes(value))
                               for k in range(records)], base_offset=records * i,
                              first_timestamp=1_000_000 + i)
            for i in range(n)]


def lz4_encoder():
    """(block encoder, its name): liblz4 where it loads, else the tests'
    small block encoder (a data generator, never on the device path)."""
    from redpanda_tpu_torch.ops.lz4_device import lz4_block_compress

    try:
        lz4_block_compress(b"probe")
        return lz4_block_compress, "liblz4"
    except OSError:
        sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests"))
        from lz4_block_encoder import lz4_block_encode

        return lz4_block_encode, "tests/lz4_block_encoder.py"


def crc_bound(lens, n_in_arrays: int, out_bytes_per_row: int, r: int) -> tuple[float, str]:
    """Valid bytes read once, the int32 arrays read once, the output written
    once; one table step per valid byte."""
    import numpy as np

    valid = int(np.clip(lens, 0, r).sum())
    n = len(lens)
    return bound_ms(valid + 4 * n * n_in_arrays + out_bytes_per_row * n, valid)


# ------------------------------------------------------------------ CRC phases
def raw_crc_rows_launch(kernel, data, lens, claimed, dev):
    """One launch of rp_crc_rows (rp_crc_blocks over one block) over (data,
    lens): the CRCs (K5) or, with claimed, the ok flags (K6), the C entry
    point called directly (no wrapper, not counted): (fn, its output)."""
    import torch

    from redpanda_tpu_torch.ops.crc32c_device import _layout_args

    n, r = data.shape
    out = torch.empty(n, dtype=torch.int32 if claimed is None else torch.bool, device=dev)
    crc_out, ok = (out.data_ptr(), None) if claimed is None else (None, out.data_ptr())
    argv = (data.data_ptr(), lens.data_ptr(), None if claimed is None else claimed.data_ptr(), n,
            r, *_layout_args(dev, r, n), crc_out, ok,
            torch.cuda.current_stream(dev).cuda_stream)
    fn = kernel.fn()

    def run():
        if fn(*argv) != 0:
            fail("rp_crc_rows refused its launch")

    run.tensors = (data, lens, claimed, out)  # alive while the launch may run
    return run, out


def crc_split_cases(dev) -> str:
    """K5 and K6 against their plain versions at r = 100, 2048, 4097 and
    16384 over 256, 1024 and 8192 rows (and 64 and 512 of 16384: every span
    count split_layout picks), on rows at a 16-byte boundary and one byte
    past it; lengths at the edges (0, negative, past r, round and span
    boundaries) and random, every third claim wrong."""
    import numpy as np
    import torch

    from redpanda_tpu_torch.hashing.crc32c import crc32c_many
    from redpanda_tpu_torch.ops import crc32c_device as C

    gen = torch.Generator(device=dev).manual_seed(23)
    layouts = set()
    for r in (100, 2048, 4097, 16384):
        for n in (256, 1024, 8192) + ((64, 512) if r == 16384 else ()):
            edge = torch.tensor([0, -3, r + 5, r, r - 1, 1, 15, 16, 17, 511, 512, 513, 2048,
                                 2049, 4096, 8192], dtype=torch.int32, device=dev)
            lens = torch.randint(0, r + 1, (n,), generator=gen, device=dev, dtype=torch.int32)
            lens[: len(edge)] = edge
            buf = torch.randint(0, 256, (n * r + 1,), generator=gen, device=dev,
                                dtype=torch.uint8)
            for off in (0, 1):
                d = buf[off : off + n * r].view(n, r)
                want = C.crc_plain(d, lens)
                claimed = want.clone()
                claimed[::3] ^= 0x100
                got, ok = C.crc32c_rows(d, lens), C.validate_rows(d, lens, claimed)
                if not (torch.equal(got, want)
                        and torch.equal(ok, C.validate_plain(d, lens, claimed))):
                    fail(f"crc32c / crc32c_validate != plain at r={r}, {n} rows, offset {off}")
            if n == 256:
                host = crc32c_many(d.cpu().numpy(), lens.cpu().numpy())
                if not np.array_equal(C.as_u32(got), host):
                    fail(f"crc32c kernel != host crc32c_many at r={r}")
            layouts.add(C.split_layout(r, n, C.sm_count(dev))[0])
    torch.cuda.synchronize()
    msg = (f"r = 100, 2048, 4097 and 16384 over 256, 1024 and 8192 rows (and 64 and 512 of "
           f"16384), "
           f"aligned and one byte off, {sorted(layouts)} warps a row")
    log(f"K5/K6 split cases bit-identical to the plain version: {msg}")
    if layouts != {1, 2, 4, 8}:
        fail(f"the CRC cases ran {sorted(layouts)} warps a row, not every split")
    return msg


def phase_crc_kernels(dev) -> dict:
    import numpy as np
    import torch

    from redpanda_tpu_torch import kernels
    from redpanda_tpu_torch.ops import crc32c_device as C
    from redpanda_tpu_torch.ops.packing import pack_rows

    cases = crc_split_cases(dev)
    out = {}
    # K5 at the raft append's shape, K6 at the produce path's
    regions = [b.crc_region() for b in random_batches(1024, RAFT_RECORDS, RAFT_VALUE, 1)]
    rows, lens = pack_rows(regions, 16384)
    d, ln = torch.from_numpy(rows).to(dev), torch.from_numpy(lens).to(dev)
    got, want = C.crc32c_rows(d, ln), C.crc_plain(d, ln)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        fail("crc32c kernel != plain at the raft shape")
    run, _ = raw_crc_rows_launch(kernels.CRC32C, d, ln, None, dev)
    t = {"ms": cuda_ms(lambda: C.crc32c_rows(d, ln), 100), "launch_ms": cuda_ms(run, 100)}
    plain_ms = cuda_ms(lambda: C.crc_plain(d, ln), 1)
    b_ms, b_by = crc_bound(lens, 1, 4, 16384)
    log(f"K5 raft shape: 1024 x 16384, {int(lens.sum())} valid B, "
        f"{C.split_layout(16384, 1024, C.sm_count(dev))[0]} warps a row: call {t['ms']:.4f} ms, "
        f"launch alone {t['launch_ms']:.4f}; plain {plain_ms:.2f} ms, bound "
        f"{b_ms * 1e3:.3f} us ({b_by})")
    out["crc32c"] = {"max_abs_err": max_abs_err([(got, want)]), "plain_ms": plain_ms,
                     "bound_ms": b_ms, "bound_by": b_by,
                     "parity": f"bit-identical at the raft shape 1024 x 16384 and at {cases}",
                     **t}
    PROFILE_LATER.append(("K5 raft shape", out["crc32c"], run, "crc_blocks_kernel"))
    regions, claimed = produce_regions()
    rows, lens = pack_rows(regions, 2048)
    d, ln = torch.from_numpy(rows).to(dev), torch.from_numpy(lens).to(dev)
    cl = torch.from_numpy(claimed.view(np.int32)).to(dev)
    ok, ok_want = C.validate_rows(d, ln, cl), C.validate_plain(d, ln, cl)
    torch.cuda.synchronize()
    if not torch.equal(ok, ok_want):
        fail("crc32c_validate kernel != plain at the produce shape")
    run, _ = raw_crc_rows_launch(kernels.CRC32C_VALIDATE, d, ln, cl, dev)
    t = {"ms": cuda_ms(lambda: C.validate_rows(d, ln, cl), 100), "launch_ms": cuda_ms(run, 100)}
    plain_ms = cuda_ms(lambda: C.validate_plain(d, ln, cl), 1)
    b_ms, b_by = crc_bound(lens, 2, 1, 2048)
    log(f"K6 produce shape: 1024 x 2048, {int(lens.sum())} valid B: call {t['ms']:.4f} ms, "
        f"launch alone {t['launch_ms']:.4f}; plain {plain_ms:.2f} ms, bound "
        f"{b_ms * 1e3:.3f} us ({b_by})")
    out["crc32c_validate"] = {"max_abs_err": max_abs_err([(ok, ok_want)]), "plain_ms": plain_ms,
                              "bound_ms": b_ms, "bound_by": b_by,
                              "parity": f"bit-identical at the produce shape 1024 x 2048 and at "
                                        f"{cases}", **t}
    PROFILE_LATER.append(("K6 produce shape", out["crc32c_validate"], run, "crc_blocks_kernel"))
    return out


def phase_produce(dev) -> dict:
    import numpy as np

    from redpanda_tpu_torch import kernels
    from redpanda_tpu_torch.ops.crc_backend import CrcBackend

    regions, claimed = produce_regions()
    bad = claimed.copy()
    bad[517] ^= 0x40
    host = CrcBackend("host").validate(regions, bad)
    device = CrcBackend("device", device=dev)
    device.validate(regions, claimed)  # build and first launch
    kernels.reset_launches()  # the produce path starts here
    t0 = time.perf_counter()
    ok = device.validate(regions, bad)
    t_dev = time.perf_counter() - t0
    picked = CrcBackend.pick(regions, reps=8, device=dev)
    launches = path_launches("produce", kernels.CRC32C_VALIDATE)  # the produce path ends here
    if not np.array_equal(ok, host) or ok[517] or ok.sum() != len(regions) - 1:
        fail("produce path: device flags differ from the host backend's")
    d = picked.decision
    log(f"produce path (config 1): {len(regions)} regions of {len(regions[0])} B at r=2048: "
        f"CrcBackend('device') {len(regions) / t_dev:.1f} batches/s in one call, the corrupt "
        f"batch rejected; pick(reps=8): host {d.host_batches_per_sec:.1f} batches/s, device "
        f"{d.device_batches_per_sec:.1f} batches/s, chose {picked.backend}")
    return launches


def phase_raft(dev) -> dict:
    import numpy as np

    from redpanda_tpu_torch import kernels
    from redpanda_tpu_torch.raft.device_plane import RaftDevicePlane, _host_validate

    n = RAFT_PARTITIONS * RAFT_BATCHES
    batches = random_batches(n, RAFT_RECORDS, RAFT_VALUE, 2)
    regions = [b.crc_region() for b in batches]
    claimed = np.array([b.header.crc for b in batches], np.uint32)
    claimed[[3, n // 2, n - 1]] ^= 0x1
    want = _host_validate(regions, claimed)
    pinned = RaftDevicePlane(probe=False, device=dev)
    pinned.validate(regions[:64], claimed[:64])  # build and first launch
    probing = RaftDevicePlane(probe=True, device=dev)
    kernels.reset_launches()  # the raft path starts here
    t0 = time.perf_counter()
    ok = pinned.validate(regions, claimed)
    t_dev = time.perf_counter() - t0
    ok_probe = probing.validate(regions, claimed)
    launches = path_launches("raft", kernels.CRC32C)  # the raft path ends here
    if not (np.array_equal(ok, want) and np.array_equal(ok_probe, want)) or ok.sum() != n - 3:
        fail("raft path: device flags differ from the host oracle's")
    nbytes = sum(len(x) for x in regions)
    p = probing.stats()["probe"]
    NOTES["raft_plane_ms"] = t_dev * 1e3
    log(f"raft follower (config 5): {RAFT_PARTITIONS} partitions x {RAFT_BATCHES} batches, "
        f"{n} regions of ~{nbytes // n} B (rows of 16384): pinned device plane "
        f"{t_dev * 1e3:.3f} ms per append ({n / t_dev:.1f} batches/s, {nbytes / t_dev / 1e6:.1f} MB/s "
        f"incl. pack and copies); probe t_host_ms {p['t_host_ms']}, t_device_ms "
        f"{p['t_device_ms']}, speedup {p['speedup']}, chose {p['chosen']}")
    return launches


def phase_recovery(dev) -> dict:
    from redpanda_tpu_torch import kernels
    from redpanda_tpu_torch.storage.recovery import (
        scan_valid_prefix_device, scan_valid_prefix_host)

    frames = [b.encode_internal() for b in
              random_batches(SEGMENT_FRAMES, SEGMENT_RECORDS, SEGMENT_VALUE, 3)]
    blob = b"".join(frames)
    torn = blob[: len(blob) - len(frames[-1]) // 2]
    corrupt = bytearray(blob)
    corrupt[len(blob) - 3 * len(frames[-1]) + 300] ^= 0xFF  # a payload byte, third frame from the end
    corrupt = bytes(corrupt)
    scan_valid_prefix_device(blob[:100_000], device=dev)  # build and first launch
    kernels.reset_launches()  # the recovery path starts here
    t0 = time.perf_counter()
    got = scan_valid_prefix_device(torn, device=dev)
    t_dev = time.perf_counter() - t0
    got_corrupt = scan_valid_prefix_device(corrupt, device=dev)
    launches = path_launches("recovery", kernels.CRC32C)  # the recovery path ends here
    t0 = time.perf_counter()
    want = scan_valid_prefix_host(torn)
    t_host = time.perf_counter() - t0
    want_corrupt = scan_valid_prefix_host(corrupt)
    if got != want or got_corrupt != want_corrupt:
        fail(f"recovery scan: device {got}/{got_corrupt} != host {want}/{want_corrupt}")
    if got[0] != len(blob) - len(frames[-1]) or got_corrupt[0] != len(blob) - 3 * len(frames[-1]):
        fail(f"recovery scan cut at the wrong frame: {got}, {got_corrupt}")
    log(f"recovery scan: {len(blob) / 2**20:.1f} MiB segment, {len(frames)} frames of "
        f"{len(frames[0])} B, torn tail: device scan {t_dev * 1e3:.2f} ms "
        f"({len(torn) / t_dev / 1e6:.1f} MB/s), host scan {t_host * 1e3:.2f} ms "
        f"({len(torn) / t_host / 1e6:.1f} MB/s); valid prefix {got} equal on both, "
        f"and {got_corrupt} with a corrupt frame")
    return launches


def tail_segment(log_dir: str) -> str:
    stems = sorted((f for f in os.listdir(log_dir) if f.endswith(".log")),
                   key=lambda f: int(f.split("-")[0]))
    return os.path.join(log_dir, stems[-1])


async def reopen_logs(config, ntps) -> tuple:
    """A LogManager over ``config`` opening every NTP in turn, as a restart
    does: (manager, logs, seconds of each open, seconds of all)."""
    from redpanda_tpu_torch.storage import LogManager

    mgr = LogManager(config)
    logs, per_log = [], []
    t_all = time.perf_counter()
    for n in ntps:
        t0 = time.perf_counter()
        logs.append(await mgr.manage(n))
        per_log.append(time.perf_counter() - t0)
    return mgr, logs, per_log, time.perf_counter() - t_all


def phase_restart(dev, partitions: int = P, batches: int = RESTART_BATCHES) -> dict:
    """A broker restart over config 4's partitions: every log's tail
    recovered through DiskLog.open -> recover_segment -> K5 on the card,
    against the same directory reopened with host recovery."""
    import asyncio
    import shutil
    import statistics
    import tempfile

    from redpanda_tpu_torch import kernels
    from redpanda_tpu_torch.models import NTP
    from redpanda_tpu_torch.storage import LogConfig, LogManager
    from redpanda_tpu_torch.storage.recovery import scan_valid_prefix_host

    fill = random_batches(batches, SEGMENT_RECORDS, SEGMENT_VALUE, 4)
    frame = fill[0].size_bytes
    ntps = [NTP.kafka("restart", p) for p in range(partitions)]
    corrupt_p = partitions // 3
    with tempfile.TemporaryDirectory(prefix="chip-smoke-restart-") as tmp:
        card_dir, host_dir = os.path.join(tmp, "card"), os.path.join(tmp, "host")
        card_cfg = LogConfig(base_dir=card_dir, use_device_recovery=True,
                             recovery_device=str(dev), fsync_on_append=False)
        host_cfg = LogConfig(base_dir=host_dir, fsync_on_append=False)

        async def fill_logs():
            mgr = LogManager(card_cfg)
            for n in ntps:
                await (await mgr.manage(n)).append(list(fill))
            await mgr.stop()

        t0 = time.perf_counter()
        asyncio.run(fill_logs())
        t_fill = time.perf_counter() - t0
        cuts, scanned = [], 0
        for p, n in enumerate(ntps):
            path = tail_segment(os.path.join(card_dir, n.path()))
            with open(path, "rb") as f:
                blob = bytearray(f.read())
            if p == corrupt_p:
                blob[len(blob) - 3 * frame + 300] ^= 0xFF  # a payload byte, third frame from the end
            blob = bytes(blob[: len(blob) - frame // 2])  # the last frame torn in half
            with open(path, "wb") as f:
                f.write(blob)
            cuts.append(scan_valid_prefix_host(blob))
            scanned += len(blob)
        shutil.copytree(card_dir, host_dir)

        async def restart():
            kernels.reset_launches()  # the restart's device path starts here
            card = await reopen_logs(card_cfg, ntps)
            launches = path_launches("restart", kernels.CRC32C)  # ... and ends here
            host = await reopen_logs(host_cfg, ntps)
            try:
                for p, (lc, lh) in enumerate(zip(card[1], host[1])):
                    oc, oh = lc.offsets(), lh.offsets()
                    if oc != oh or oc.dirty_offset != cuts[p][1]:
                        fail(f"restart: partition {p} offsets {oc} (card) / {oh} (host), the "
                             f"host scan cuts at {cuts[p]}")
                    if lc.segments[-1].size_bytes != cuts[p][0]:
                        fail(f"restart: partition {p} tail cut at {lc.segments[-1].size_bytes} B, "
                             f"the host scan names {cuts[p][0]}")
                    tail = await lc.read(oc.dirty_offset + 1 - 32 * SEGMENT_RECORDS, 1 << 30)
                    if len(tail) != 32 or not all(b.verify_kafka_crc() for b in tail):
                        fail(f"restart: partition {p}'s last 32 batches do not verify")
                    rc = await lc.append([fill[0]])
                    rh = await lh.append([fill[0]])
                    if rc.base_offset != oc.dirty_offset + 1 or rh.base_offset != rc.base_offset:
                        fail(f"restart: partition {p} appended at {rc.base_offset} / "
                             f"{rh.base_offset}, want {oc.dirty_offset + 1}")
            finally:
                await card[0].stop()
                await host[0].stop()
            return launches, card, host

        launches, card, host = asyncio.run(restart())
        if launches["crc32c"] != partitions:
            fail(f"restart: {launches['crc32c']} crc32c launches on the card's reopen, want one "
                 f"a partition ({partitions})")
        for n in ntps:
            names = sorted(os.listdir(os.path.join(card_dir, n.path())))
            if names != sorted(os.listdir(os.path.join(host_dir, n.path()))):
                fail(f"restart: {n.path()} holds other files after the two reopens")
            for name in names:
                with open(os.path.join(card_dir, n.path(), name), "rb") as a, \
                        open(os.path.join(host_dir, n.path(), name), "rb") as b:
                    if a.read() != b.read():
                        fail(f"restart: {n.path()}/{name} differs between the two reopens")
    t_card, t_host = card[3], host[3]
    log(f"restart (config 4's {partitions} partitions x {batches} batches of {frame} B, "
        f"{scanned / 2**20:.1f} MiB of tails, every tail torn, partition {corrupt_p} with a "
        f"corrupt frame): fill {t_fill:.2f} s; reopen with device recovery {t_card:.3f} s "
        f"({scanned / t_card / 1e6:.1f} MB/s, median {statistics.median(card[2]) * 1e3:.2f} ms a "
        f"log), with host recovery {t_host:.3f} s ({scanned / t_host / 1e6:.1f} MB/s, median "
        f"{statistics.median(host[2]) * 1e3:.2f} ms a log); crc32c launches {launches['crc32c']}; "
        f"cuts, offsets and files equal on both, the last 32 batches verified and one more "
        f"batch appended at dirty + 1 in every log")
    return launches


# ------------------------------------------------------------------ runtime phase
RUNTIME_BATCHES = 64  # phase 7c: a partition's backlog, 2048 records (~2.1 MB)
RUNTIME_WAIT_S = 300.0  # a ceiling for the backlog's transform, not a pace


def runtime_records(batches) -> list:
    """(key, value, headers) of every record, in order; every batch must
    verify its Kafka CRC."""
    out = []
    for b in batches:
        if not b.verify_kafka_crc():
            fail(f"runtime: a materialized batch at {b.base_offset} does not verify its CRC")
        out += [(r.key, r.value, tuple((h.key, h.value) for h in r.headers)) for r in b.records()]
    return out


def direct_records(dev, spec, requests) -> dict:
    """Each partition's records through a TorchEngine on the card (K1
    pinned, the runtime's default row stride): {partition: records}."""
    from redpanda_tpu_torch.coproc.engine import TorchEngine

    eng = TorchEngine(device=dev, **PIN_K1)
    try:
        if eng.enable_coprocessors([(1, spec.to_json(), ("bench",))]) != [0]:
            fail("runtime: the direct engine did not enable its spec")
        out = {p: [] for p in range(P)}
        for req in requests:
            for it in eng.process_batch(req).items:
                out[it.source.partition] += runtime_records(it.batches)
        return out
    finally:
        eng.shutdown()


async def partition_records(part, start: int = 0) -> list:
    out, off = [], start
    while off < part.high_watermark:
        batches = await part.make_reader(off, 1 << 22)
        if not batches:
            fail(f"runtime: {part.ntp} reads nothing at {off} below {part.high_watermark}")
        out += runtime_records(batches)
        off = batches[-1].last_offset + 1
    return out


def script_spans(spans, script_of: dict, name: str) -> tuple[int, dict]:
    """One script's ticks (its coproc.tick spans) and the medians (ms) of
    its read, submit, harvest and write spans, from the committed spans and
    ``script_of`` (a tick's trace id -> the script id it submitted)."""
    import statistics

    from redpanda_tpu_torch.coproc.wasm_event import WasmEvent

    sid = WasmEvent(name, b"").script_id
    mine = {tid for tid, s in script_of.items() if s == sid}
    by: dict[str, list[float]] = {}
    for sp in spans:
        if sp["trace_id"] in mine:
            by.setdefault(sp["name"], []).append(sp["dur_us"] / 1e3)
    med = {k: round(statistics.median(by[k]), 3) for k in (
        "coproc.read", "coproc.submit.wait", "coproc.harvest.wait", "coproc.write") if by.get(k)}
    return len(by.get("coproc.tick", [])), med


def phase_runtime(dev) -> dict:
    """Phase 7c: the coproc runtime over config 4 (module docstring).
    Returns K1's and K4's launches on the runtime's path."""
    import asyncio
    import tempfile

    from redpanda_tpu_torch import kernels
    from redpanda_tpu_torch.cluster import TopicConfig
    from redpanda_tpu_torch.coproc import governor
    from redpanda_tpu_torch.coproc.api import CoprocApi
    from redpanda_tpu_torch.coproc.engine import TorchEngine
    from redpanda_tpu_torch.kafka.server.broker import Broker, BrokerConfig
    from redpanda_tpu_torch.observability.trace import tracer
    from redpanda_tpu_torch.storage import KeySpace, StorageApi

    t_phase = time.perf_counter()
    scripts = {"errs": columnar_spec(), "errs_v1": payload_spec()}
    # the bench's short_msgs workload: its ~1 KB records in the pad field, so
    # that msgs of 0-89 bytes survive the projection (the bench workload's
    # ~900-byte msgs fit no Str("msg", 64): every materialized log would
    # stay empty)
    requests = [build_request(True, seed=b) for b in range(RUNTIME_BATCHES)]
    extra = build_request(True, seed=RUNTIME_BATCHES)  # the restart's one more batch a partition
    backlog = {p: [req.items[p].batches[0] for req in requests] for p in range(P)}
    n_records = sum(len(b.records()) for bs in backlog.values() for b in bs)
    sizes = [len(r.value) for bs in backlog.values() for b in bs for r in b.records()]
    n_fit = sum(s <= 1024 for s in sizes)
    want = {name: direct_records(dev, spec, requests) for name, spec in scripts.items()}
    want_extra = {name: direct_records(dev, spec, [extra]) for name, spec in scripts.items()}
    last = RUNTIME_BATCHES * RECORDS_PER_BATCH - 1
    spans, script_of = [], {}

    async def start(d):
        storage = await StorageApi(d).start()
        broker = Broker(BrokerConfig(data_dir=d), storage)
        await broker.recover_topics()  # what KafkaServer.start does in the JAX package
        api = await CoprocApi(broker, device=str(dev)).start()
        return storage, broker, api

    def offsets_at(api, name, off) -> bool:
        ctx = api.pacemaker.scripts().get(name)
        return ctx is not None and len(ctx.offsets) == P and all(
            v == off for v in ctx.offsets.values())

    async def wait_for(pred, what, timeout=RUNTIME_WAIT_S):
        t0 = time.perf_counter()
        while not pred():
            if time.perf_counter() - t0 > timeout:
                fail(f"runtime: {what} not within {timeout:.0f} s")
            await asyncio.sleep(0.005)
        return time.perf_counter()

    def hwms(broker) -> dict:
        return {(n, p): broker.get_partition(f"bench.${n}$", p).high_watermark
                for n in scripts for p in range(P)}

    async def first_run(d):
        storage, broker, api = await start(d)
        try:
            await broker.create_topic(TopicConfig("bench", P))
            t0 = time.perf_counter()
            for p, batches in backlog.items():
                await broker.get_partition("bench", p).replicate(batches, 0)
            t_write = time.perf_counter() - t0
            engine_submit = api.engine.submit

            def submit(req):  # which script each tick's trace belongs to
                script_of[req.trace_id] = req.items[0].script_id
                return engine_submit(req)

            api.engine.submit = submit
            tracer.configure(enabled=True, slow_threshold_ms=60_000)
            tracer.set_sink(spans.append)
            f0 = failures_total()
            kernels.reset_launches()  # the runtime's device path starts here
            t_deploy = {}
            for name, spec in scripts.items():
                t_deploy[name] = time.perf_counter()
                await api.deploy(name, spec.to_json(), ["bench"])
            t_done = {}  # each script's last offset, polled together

            def all_done() -> bool:
                for n in scripts:
                    if n not in t_done and offsets_at(api, n, last):
                        t_done[n] = time.perf_counter()
                return len(t_done) == len(scripts)

            await wait_for(all_done, "the scripts' backlog")
        finally:
            await api.stop()
            tracer.set_sink(None)
            tracer.configure(enabled=False)
        launches = path_launches("coproc runtime", kernels.PREDICATE,
                                 kernels.PAYLOAD_TRANSFORM)  # ... and ends here
        failed = failures_total() - f0
        if failed:
            fail(f"runtime: {failed:.0f} failures counted while the scripts ran "
                 "(a failed tick or launch)")
        saved = json.loads(storage.kvs.get(KeySpace.coproc, b"offsets"))
        if saved != {n: {f"kafka/bench/{p}": last for p in range(P)} for n in scripts}:
            fail(f"runtime: the saved offsets are not every partition at {last}: {saved}")
        got = {n: {p: await partition_records(broker.get_partition(f"bench.${n}$", p))
                   for p in range(P)} for n in scripts}
        for n in scripts:
            for p in range(P):
                if got[n][p] != want[n][p]:
                    fail(f"runtime: {n}'s materialized partition {p} holds "
                         f"{len(got[n][p])} records, not the direct engine's "
                         f"{len(want[n][p])} records")
        st = api.engine.stats()
        gov = api.engine.governor
        admission = [e for e in governor.journal.entries(domain=governor.ADMISSION)
                     if e["engine"] == gov.engine_tag]
        out = dict(launches=launches, t_write=t_write, t_deploy=t_deploy, t_done=t_done,
                   st=st, knobs=gov.autotune_snapshot(), admission=admission[::-1],
                   hwm=hwms(broker), got=got)
        await storage.stop()
        return out

    async def restart(d, before):
        storage, broker, api = await start(d)
        try:
            await wait_for(lambda: api.active_scripts() == sorted(scripts),
                           "the scripts' return from the event log", 30.0)
            await wait_for(lambda: all(offsets_at(api, n, last) for n in scripts),
                           "the saved offsets' return", 30.0)
            t0 = time.perf_counter()
            while time.perf_counter() - t0 < 1.0:
                if hwms(broker) != before["hwm"]:
                    fail("runtime: a materialized high watermark moved after the restart "
                         "with no new input (reprocessing)")
                await asyncio.sleep(0.01)
            for it in extra.items:
                await broker.get_partition("bench", it.ntp.partition).replicate(it.batches, 0)
            for n in scripts:
                await wait_for(lambda n=n: offsets_at(api, n, last + RECORDS_PER_BATCH),
                               f"{n}'s one more batch", 60.0)
        finally:
            await api.stop()
        for n in scripts:
            for p in range(P):
                recs = await partition_records(broker.get_partition(f"bench.${n}$", p))
                if recs != before["got"][n][p] + want_extra[n][p]:
                    fail(f"runtime: after the restart {n}'s partition {p} holds "
                         f"{len(recs)} records, not {len(before['got'][n][p])} + "
                         f"{len(want_extra[n][p])} once each")
        await storage.stop()

    TorchEngine.reset_columnar_probe()  # the runtime's engine probes afresh
    with tempfile.TemporaryDirectory(prefix="chip-smoke-runtime-") as d:
        run = asyncio.run(first_run(d))
        t0 = time.perf_counter()
        asyncio.run(restart(d, run))
        t_restart = time.perf_counter() - t0
    TorchEngine.reset_columnar_probe()
    st = run["st"]
    ticks = {}
    for name in scripts:
        ticks[name], med = script_spans(spans, script_of, name)
        secs = run["t_done"][name] - run["t_deploy"][name]
        log(f"runtime {name}: {RUNTIME_BATCHES * P} input record_batches ({n_records} records) in "
            f"{secs:.3f} s from the deploy to the last offset = {RUNTIME_BATCHES * P / secs:.1f} "
            f"record_batches/s (both scripts at once); {ticks[name]} ticks (coproc.tick spans); "
            f"span medians ms {json.dumps(med)}")
    k1, k4 = run["launches"]["predicate"], run["launches"]["payload_transform"]
    if k1 < 1 or k4 < ticks["errs_v1"]:
        fail(f"runtime: K1 {k1} launches (want >= 1, the probe's leg), K4 {k4} (want >= "
             f"errs_v1's {ticks['errs_v1']} ticks)")
    probe = st.get("columnar_probe")
    log(f"runtime columnar probe: verdict {st.get('columnar_backend')}, t_host_s "
        f"{probe and probe.get('t_host_s')}, t_device_s {probe and probe.get('t_device_s')}; "
        f"K1 launches {k1}, K4 launches {k4}, the engine's launches {st.get('n_launches', 0):.0f} "
        f"(host-pool probe {json.dumps(st.get('host_pool_probe'))}); {n_fit} of {len(sizes)} "
        f"records fit the 1024-byte payload row")
    log(f"runtime autotune: final knobs {json.dumps(run['knobs'])}; ADMISSION records "
        f"{json.dumps([(e['verdict'], e['reason']) for e in run['admission']])}")
    log(f"runtime (config 4: {P} partitions x {RUNTIME_BATCHES} batches of "
        f"{RECORDS_PER_BATCH} ~1 KB JSON records, {sum(b.size_bytes for bs in backlog.values() for b in bs) / 1e6:.1f} MB "
        f"written in {run['t_write']:.2f} s): both scripts' {P} materialized partitions equal "
        f"the direct engine's records, every batch verified its CRC, offsets saved at {last}; "
        f"restart: both scripts back from the event log, no high watermark moved over 1 s "
        f"idle, one more batch a partition materialized once ({t_restart:.2f} s); the phase "
        f"took {time.perf_counter() - t_phase:.1f} s")
    return run["launches"]


# ------------------------------------------------------------------ config 5 through raft
CONFIG5_NODES, CONFIG5_GROUPS = 3, 256  # BASELINE config 5: three nodes, 256 partitions
CONFIG5_BATCHES = 16  # a group's batches a round: 16 regions of just under 16 KiB
CONFIG5_WAIT_S = 60.0  # the ceiling for stable leaders and for a round's commits
CONFIG5_TORN = 8  # appends the honey badger tears in the torn round
# raft timings of the three brokers. A round holds the one process's GIL
# for seconds (all 768 consensus instances, their rpc and their storage are
# Python on one event loop), and a follower hears nothing from its leader
# while its append waits: at RaftTimings' 600/60 ms and at a broker's
# defaults (1500/150 ms, the JAX package's config/properties.py) the
# followers' election timers fired through the rounds and the elections
# stormed (chip_tools/raft_config5.py --election-ms 1500 --heartbeat-ms 150
# counts them). The recovery throttle is a broker's default
# (raft_recovery_concurrency, 4).
CONFIG5_ELECTION_MS, CONFIG5_HEARTBEAT_MS, CONFIG5_RECOVERY = 5000.0, 500.0, 4
NOTES = {}  # numbers one phase prints beside another's


# (node id, raft group) of the follower append a task serves: set around
# each counted append and copied into the worker thread that validates it
# (asyncio.to_thread copies the context), where attribute_launches reads it
APPEND_AT = contextvars.ContextVar("append_at", default=None)


class Config5Node:
    """One broker of phase 7d: a port StorageApi, an rpc.Server on
    127.0.0.1:0 and a GroupManager on the card."""

    def __init__(self, node_id: int, base_dir: str, dev):
        from redpanda_tpu_torch import rpc

        self.node_id, self.base_dir, self.dev = node_id, base_dir, dev
        self.connections = rpc.ConnectionCache()
        self.storage = self.server = self.gm = None
        self.appends = 0  # append_entries requests that carried batches
        self.appends0 = 0  # ... of them, group 0's (the controller's, phase 7e)
        self.ticks = []  # (peers, last_tick_acks, want, seconds) of each tally

    def add_services(self, proto) -> None:
        """More rpc services on the node's protocol (phase 7e's)."""

    async def start(self):
        from redpanda_tpu_torch import rpc
        from redpanda_tpu_torch.raft import GroupManager, RaftTimings, VNode
        from redpanda_tpu_torch.storage import StorageApi

        self.storage = await StorageApi(self.base_dir).start()
        self.gm = GroupManager(VNode(self.node_id, 0), self.storage, self.connections,
                               timings=RaftTimings(CONFIG5_ELECTION_MS, CONFIG5_HEARTBEAT_MS),
                               device=self.dev, recovery_concurrency=CONFIG5_RECOVERY)
        proto = rpc.SimpleProtocol(node_id=self.node_id)
        self.gm.register_service(proto)
        self.add_services(proto)
        self.server = rpc.Server("127.0.0.1", 0)
        self.server.set_protocol(proto)
        await self.server.start()
        service, hb = self.gm.service, self.gm.heartbeats
        append_entries, tally = service.append_entries, hb._tally_acks

        async def counted_append(req):
            if req["batches"] and self.gm.consensus_for(req["group"]) is not None:
                self.appends += 1
                self.appends0 += req["group"] == 0
            APPEND_AT.set((self.node_id, req["group"]))  # this request's task alone
            return await append_entries(req)

        def counted_tally(acks):  # a test double around the tally's input
            import numpy as np

            t0 = time.perf_counter()
            tally(acks)
            secs = time.perf_counter() - t0
            if not acks:
                return
            groups = sorted(hb._groups)
            bits = np.array([[1 if (a or {}).get(g) else 0 for g in groups] for a in acks],
                            np.int64).reshape(len(acks), len(groups))
            want = dict(zip(groups, bits.sum(axis=0).tolist()))
            self.ticks.append((len(acks), dict(hb.last_tick_acks), want, secs))

        service.append_entries, hb._tally_acks = counted_append, counted_tally
        await self.gm.start()
        return self

    async def stop(self):
        try:
            if self.gm is not None:
                await self.gm.stop()
        finally:
            try:
                if self.server is not None:
                    await self.server.stop()
            finally:
                try:
                    if self.storage is not None:
                        await self.storage.stop()
                finally:
                    await self.connections.close()


def config5_config_batch(voters) -> list:
    """A raft_configuration batch as an election appends it."""
    from redpanda_tpu_torch.models import Record, RecordBatch
    from redpanda_tpu_torch.models.record import RecordBatchType
    from redpanda_tpu_torch.raft import GroupConfiguration

    return [RecordBatch.build([Record(offset_delta=0, value=GroupConfiguration(voters).encode())],
                              type=RecordBatchType.raft_configuration)]


def config5_fd_limit() -> tuple[int, int, int]:
    """The process's open-file limits, the soft one raised to the hard one
    when it is short of what 768 logs, their sockets and the card need."""
    import resource

    need = 2 * CONFIG5_NODES * CONFIG5_GROUPS + 512
    soft, hard = resource.getrlimit(resource.RLIMIT_NOFILE)
    raised = soft
    if soft != resource.RLIM_INFINITY and soft < need:
        if hard != resource.RLIM_INFINITY and hard < need:
            fail(f"config 5: RLIMIT_NOFILE soft {soft}, hard {hard}: {need} needed for "
                 f"{CONFIG5_NODES * CONFIG5_GROUPS} open logs and their sockets")
        raised = hard if hard != resource.RLIM_INFINITY else need
        resource.setrlimit(resource.RLIMIT_NOFILE, (raised, hard))
    return soft, hard, raised


async def config5_stable_leaders(nodes, groups) -> tuple[dict, float]:
    """tests/raft_stability.py's rule for every group: a leader counts once
    it has survived one election timeout in the same term with an entry of
    its own term committed. Returns {group: (leader node, term)}."""
    import asyncio

    t0 = time.perf_counter()
    stable, timeout_s = {}, nodes[0].gm.timings.election_timeout_ms / 1000.0
    while len(stable) < len(groups):
        if time.perf_counter() - t0 > CONFIG5_WAIT_S:
            fail(f"config 5: {len(groups) - len(stable)} of {len(groups)} groups had no stable "
                 f"leader within {CONFIG5_WAIT_S:.0f} s")
        seen = {}
        for g in groups:
            if g in stable:
                continue
            for n in nodes:
                c = n.gm.consensus_for(g)
                if c.is_leader():
                    seen[g] = (n, c.term)
        await asyncio.sleep(timeout_s)
        for g, (n, term) in seen.items():
            c = n.gm.consensus_for(g)
            if c.is_leader() and c.term == term and c.leadership_settled():
                stable[g] = (n, term)
    return stable, time.perf_counter() - t0


async def config5_leaders(nodes, groups) -> dict:
    """{group: (leader node, term)} once every group has a leader."""
    import asyncio

    t0 = time.perf_counter()
    while True:
        out = {}
        for g in groups:
            for n in nodes:
                c = n.gm.consensus_for(g)
                if c.is_leader():
                    out[g] = (n, c.term)
        if len(out) == len(groups):
            return out
        if time.perf_counter() - t0 > CONFIG5_WAIT_S:
            fail(f"config 5: {len(groups) - len(out)} groups without a leader for "
                 f"{CONFIG5_WAIT_S:.0f} s")
        await asyncio.sleep(0.05)


async def log_range(c, first: int, last: int) -> list:
    """A consensus instance's log from ``first`` to ``last`` as (term,
    internal bytes) of each batch."""
    import asyncio

    out, at = [], first
    while at <= last:
        got = c.log.read(at, 1 << 20, max_offset=last)
        if asyncio.iscoroutine(got):
            got = await got
        if not got:
            break
        out += [(b.header.term, b.encode_internal()) for b in got]
        at = got[-1].last_offset + 1
    return out


def config5_pool() -> list:
    """Config 5's batches, CONFIG5_BATCHES a group, built once a process:
    every round of phases 7d and 7e sends fresh headers over them."""
    if "pool" not in NOTES:
        NOTES["pool"] = random_batches(CONFIG5_GROUPS * CONFIG5_BATCHES, RAFT_RECORDS,
                                       RAFT_VALUE, 5)
    return NOTES["pool"]


async def config5_round(nodes, leaders, batches, what: str, partition_of=None) -> dict:
    """One round: every group's CONFIG5_BATCHES batches replicated at
    quorum_ack, all groups at once, each replicate sent to its group's
    leader and, where an election deposed that leader meanwhile (not_leader),
    sent again to the new one, as a producer retries; then every replica of
    the round's range equal to its leader's, byte for byte, and the leader
    holding every payload sent: once each, or, for a group with a resent
    batch, at least once (a deposed leader's append may still commit).
    With ``partition_of(node, group)`` each replicate goes through the
    leader's ``Partition.replicate`` (Kafka offsets, raft's 10 s timeout,
    which a producer also retries) and the range ends at the leader's last
    raft offset. Returns the round's rates, resends and
    raft_replicate_hist's quantiles."""
    import asyncio
    import dataclasses

    from redpanda_tpu_torch.models import RecordBatch
    from redpanda_tpu_torch.observability import probes
    from redpanda_tpu_torch.raft import ConsistencyLevel, Errc, RaftError
    from redpanda_tpu_torch.utils.hdr import HdrHist

    first = {g: n.gm.consensus_for(g).dirty_offset + 1 for g, (n, _t) in leaders.items()}
    resent = {g: 0 for g in leaders}
    timed_out = [0]
    retried = (Errc.not_leader,) if partition_of is None else (Errc.not_leader, Errc.timeout)
    probes.raft_replicate_hist.hist = HdrHist()  # this round's samples alone

    def leader_of(g):
        for n in nodes:
            c = n.gm.consensus_for(g)
            if c.is_leader():
                return c
        return None

    async def one(g, b):
        deadline = time.perf_counter() + CONFIG5_WAIT_S
        while True:
            c = leader_of(g)
            if c is not None:
                copy = RecordBatch(dataclasses.replace(b.header), b.payload)
                try:
                    if partition_of is not None:
                        node = next(n for n in nodes if n.node_id == c.self_node.id)
                        return await partition_of(node, g).replicate(
                            [copy], ConsistencyLevel.quorum_ack)
                    return await c.replicate([copy], ConsistencyLevel.quorum_ack,
                                             timeout=CONFIG5_WAIT_S)
                except RaftError as e:
                    if e.errc not in retried:
                        raise
                    timed_out[0] += e.errc == Errc.timeout
                resent[g] += 1
            if time.perf_counter() > deadline:
                fail(f"config 5 {what}: group {g} found no leader to take a batch "
                     f"within {CONFIG5_WAIT_S:.0f} s")
            await asyncio.sleep(0.05)

    t0 = time.perf_counter()
    results = await asyncio.gather(*(one(g, b) for g in leaders for b in batches[g]))
    secs = time.perf_counter() - t0
    hist = probes.raft_replicate_hist.hist
    last = {}
    for (g, _b), r in zip(((g, b) for g in leaders for b in batches[g]), results):
        last[g] = max(last.get(g, -1), r.last_offset)
    if partition_of is not None:  # Kafka offsets: the range ends at raft's last
        for g in leaders:
            last[g] = (leader_of(g) or leaders[g][0].gm.consensus_for(g)).dirty_offset
    deadline = time.perf_counter() + CONFIG5_WAIT_S
    for g, off in last.items():
        while not all(n.gm.consensus_for(g).commit_index >= off for n in nodes):
            if time.perf_counter() > deadline:
                fail(f"config 5 {what}: group {g}'s followers did not commit {off}")
            await asyncio.sleep(0.01)
    for g in leaders:
        logs = {}
        for n in nodes:
            logs[n.node_id] = await log_range(n.gm.consensus_for(g), first[g], last[g])
        leader = leader_of(g)
        want = logs[leader.self_node.id] if leader is not None else logs[nodes[0].node_id]
        if any(logs[n.node_id] != want for n in nodes):
            fail(f"config 5 {what}: group {g}: a follower's log differs from its leader's")
        sent = sorted(b.payload for b in batches[g])
        held = [RecordBatch.decode_internal(raw)[0] for _t, raw in want]
        held = sorted(h.payload for h in held if h.header.type == batches[g][0].header.type)
        if (held != sent if not resent[g] else
                set(held) != set(sent) or len(held) > len(sent) + resent[g]):
            fail(f"config 5 {what}: group {g}'s leader holds {len(held)} batches, not the "
                 f"{len(sent)} sent ({resent[g]} resent)")
        await asyncio.sleep(0)  # the heartbeats run between groups
    n_batches = sum(len(v) for v in batches.values())
    nbytes = sum(b.size_bytes for v in batches.values() for b in v)
    return {"secs": secs, "batches_per_s": n_batches / secs, "mb_per_s": nbytes / secs / 1e6,
            "p50_ms": hist.percentile(50) / 1e3, "p99_ms": hist.percentile(99) / 1e3,
            "n": hist.count, "bytes": nbytes, "resent": sum(resent.values()),
            "resent_groups": sum(1 for v in resent.values() if v), "timed_out": timed_out[0]}


def phase_config5(dev) -> dict:
    """Phase 7d: BASELINE config 5 through raft (module docstring). Returns
    K5's, K8's and K7's launches on the consensus path."""
    import asyncio
    import tempfile

    import numpy as np

    from redpanda_tpu_torch import kernels
    from redpanda_tpu_torch.finjector import honey_badger
    from redpanda_tpu_torch.models import NTP
    from redpanda_tpu_torch.parallel import partition_mesh
    from redpanda_tpu_torch.raft import VNode, device_plane
    from redpanda_tpu_torch.raft.consensus import raft_crc_rejected

    t_phase = time.perf_counter()
    soft, hard, raised = config5_fd_limit()
    groups = list(range(CONFIG5_GROUPS))
    # every round's batches, built before the cluster starts: building them
    # on the running loop would starve its heartbeats; each round sends
    # fresh headers over the same payloads
    pool = config5_pool()
    batches = {g: pool[g * CONFIG5_BATCHES:(g + 1) * CONFIG5_BATCHES] for g in groups}
    out, launches = {}, {}

    def counted(what: str, r: dict, *expected) -> None:
        """Add a round's K5, K8 and K7 launches (counted from just before
        the round to just after it) to the phase's; fail when a kernel of
        the round's path was not launched."""
        for k in (kernels.CRC32C, kernels.CRC32C_VOTE, kernels.VOTE_TALLY):
            if k in expected and r["launched"][k.name] <= 0:
                fail(f"kernel {k.name} was not launched on the config 5 {what} path")
            launches[k.name] = launches.get(k.name, 0) + r["launched"][k.name]

    async def run_round(nodes, what, plane):
        leaders = await config5_leaders(nodes, groups)  # as they stand now
        for n in nodes:
            n.appends, n.ticks = 0, []
        stats0, rej0 = plane.stats(), raft_crc_rejected.value
        lags = []

        async def lag_probe():  # how late the loop's timers fire during the round
            while True:
                t0 = time.perf_counter()
                await asyncio.sleep(0.01)
                lags.append(time.perf_counter() - t0 - 0.01)

        probe = asyncio.ensure_future(lag_probe())
        kernels.reset_launches()  # the round's consensus path starts here
        try:
            r = await config5_round(nodes, leaders, batches, what)
        finally:
            probe.cancel()
        lags.sort()
        r["lag_max_ms"] = lags[-1] * 1e3 if lags else 0.0
        r["lag_p99_ms"] = lags[int(len(lags) * 0.99)] * 1e3 if lags else 0.0
        r["appends"] = sum(n.appends for n in nodes)
        r["ticks"] = [t for n in nodes for t in n.ticks]
        r["launched"] = {k.name: k.launches for k in kernels.KERNELS}  # ... and ends here
        stats1 = plane.stats()
        r["plane"] = stats1
        r["validations"] = stats1["validations"] - stats0["validations"]
        r["rows"] = stats1["rows_validated"] - stats0["rows_validated"]
        r["tallies"] = stats1["tallies"] - stats0["tallies"]
        r["rejected"] = raft_crc_rejected.value - rej0
        return r

    async def main(d):
        nodes = [Config5Node(i, os.path.join(d, f"n{i}"), dev) for i in range(CONFIG5_NODES)]
        try:
            for n in nodes:
                await n.start()
            for a in nodes:
                for b in nodes:
                    if a is not b:
                        a.connections.register(b.node_id, "127.0.0.1", b.server.port)
            # run A: the single-card leg, pinned, under every group's consensus
            voters = [VNode(i, 0) for i in range(CONFIG5_NODES)]
            pinned = device_plane.RaftDevicePlane(probe=False, device=dev)
            mesh_plane = device_plane.RaftDevicePlane(
                mesh=partition_mesh(devices=[dev, dev]), probe=False, device=dev)
            for plane in (pinned, mesh_plane):
                # each plane's first appends (an election's configuration
                # batch, a round's data) build its step for their width and
                # launch once here: done by the first append a follower
                # takes, it held that append past the election timeout, and
                # the heartbeats skip a follower while its append is out
                for regions in (config5_config_batch(voters), batches[0]):
                    plane.validate([x.crc_region() for x in regions],
                                   [x.header.crc for x in regions])
            mesh_plane.tally_votes(np.zeros((2, CONFIG5_GROUPS), np.uint8))
            device_plane.install_default_plane(pinned)
            device_plane.configure(crc_validate=True, vote_tally=True)
            t0 = time.perf_counter()
            for g in groups:
                for n in nodes:
                    await n.gm.create_group(g, NTP("kafka", "config5", g), voters)
            t_create = time.perf_counter() - t0
            leaders, t_stable = await config5_stable_leaders(nodes, groups)
            out["terms0"] = {g: t for g, (_n, t) in leaders.items()}
            out["spread"] = [sum(1 for n, _t in leaders.values() if n is node) for node in nodes]
            out["t_create"], out["t_stable"] = t_create, t_stable
            a = out["A"] = await run_round(nodes, "run A", pinned)
            if a["rejected"]:
                fail(f"config 5 run A: {a['rejected']:.0f} batches rejected on a clean round")
            k5 = a["launched"]["crc32c"]
            if not a["appends"] <= k5 <= a["validations"]:
                fail(f"config 5 run A: {k5} K5 launches for {a['appends']} appends that carried "
                     f"batches and {a['validations']} validations")
            counted("run A", a, kernels.CRC32C)
            # the torn append: the honey badger flips a byte of CONFIG5_TORN appends
            honey_badger.enable()
            honey_badger.set_corrupt("raft", "append_blob", count=CONFIG5_TORN)
            try:
                t = out["torn"] = await run_round(nodes, "torn round", pinned)
                left = honey_badger.remaining("raft", "append_blob")
            finally:
                honey_badger.unset("raft", "append_blob")
                honey_badger.disable()
            if t["rejected"] != CONFIG5_TORN or left:
                fail(f"config 5 torn round: raft_crc_rejected rose by {t['rejected']:.0f}, "
                     f"{left} tears left unused; want {CONFIG5_TORN} and 0")
            counted("torn round", t, kernels.CRC32C)
            # run B: the mesh leg, two shards (one a peer) on the one card
            device_plane.install_default_plane(mesh_plane)
            b = out["B"] = await run_round(nodes, "run B", mesh_plane)
            if b["rejected"]:
                fail(f"config 5 run B: {b['rejected']:.0f} batches rejected on a clean round")
            k8, k7 = b["launched"]["crc32c_vote"], b["launched"]["vote_tally"]
            two_peer = sum(1 for tick in b["ticks"] if tick[0] == 2)
            if not b["appends"] <= k8 <= b["validations"]:
                fail(f"config 5 run B: {k8} K8 launches for {b['appends']} appends that carried "
                     f"batches and {b['validations']} validations")
            if k7 < two_peer or two_peer == 0:
                fail(f"config 5 run B: {k7} K7 launches for {two_peer} ticks that heard both peers")
            bad = [(got, want) for _rows, got, want, _s in b["ticks"] if got != want]
            if bad:
                fail(f"config 5 run B: {len(bad)} ticks' last_tick_acks differ from the numpy "
                     f"count of their acks")
            b["two_peer"] = two_peer
            counted("run B", b, kernels.CRC32C_VOTE, kernels.VOTE_TALLY)
            # run C: the reference's default, the probing plane
            device_plane.reset_default_plane()
            probing = device_plane.default_plane(dev)
            c = out["C"] = await run_round(nodes, "run C", probing)
            counted("run C", c)
            terms = {g: max(n.gm.consensus_for(g).term for n in nodes) for g in groups}
            out["elections_after"] = sum(terms[g] - out["terms0"][g] for g in groups)
            out["leaders_end"] = [sum(1 for g in groups if n.gm.consensus_for(g).is_leader())
                                  for n in nodes]
        finally:
            try:
                for n in nodes:
                    await n.stop()
            finally:
                device_plane.configure(crc_validate=False, vote_tally=False)
                device_plane.reset_default_plane()
        return out

    with tempfile.TemporaryDirectory(prefix="chip-smoke-config5-") as d:
        out = asyncio.run(main(d))
    a, t, b, c = out["A"], out["torn"], out["B"], out["C"]

    def tally_ms(r, at=None) -> float:
        secs = sorted(tick[3] for tick in r["ticks"])
        return secs[len(secs) // 2 if at is None else at] * 1e3 if secs else float("nan")

    log(f"config 5 (raft, {CONFIG5_NODES} nodes x {CONFIG5_GROUPS} groups in one process over "
        f"localhost TCP, election timeout {CONFIG5_ELECTION_MS:.0f} ms, heartbeat "
        f"{CONFIG5_HEARTBEAT_MS:.0f} ms, recovery throttle {CONFIG5_RECOVERY}): RLIMIT_NOFILE soft {soft} hard {hard} (now {raised}); groups created in "
        f"{out['t_create']:.2f} s, every group's leader stable after {out['t_stable']:.2f} s; "
        f"leaders per node {out['spread']} (at the end {out['leaders_end']}); "
        f"{out['elections_after']} elections after the first stable view")
    for name, r in (("run A (single-card plane, K5)", a), ("torn round (single-card plane)", t),
                    ("run B (2-shard mesh plane, K8 + K7)", b), ("run C (probing plane)", c)):
        log(f"config 5 {name}: {r['n']} replicates of 1 batch ({r['bytes'] / 1e6:.1f} MB) "
            f"committed on every replica in {r['secs']:.3f} s = {r['batches_per_s']:.1f} "
            f"batches/s, {r['mb_per_s']:.1f} MB/s; raft_replicate_hist p50 {r['p50_ms']:.3f} ms "
            f"p99 {r['p99_ms']:.3f} ms (bucket bounds); {r['resent']} replicates resent to a new "
            f"leader in {r['resent_groups']} groups; {r['appends']} appends carried batches, "
            f"{r['validations']} validations of {r['rows']} rows, {r['tallies']} tallies "
            f"({len(r['ticks'])} ticks, {sum(1 for x in r['ticks'] if x[0] == 2)} to both peers, "
            f"_tally_acks median {tally_ms(r):.4f} ms max {tally_ms(r, -1):.4f} ms); the loop's "
            f"timers late by max {r['lag_max_ms']:.1f} ms, p99 {r['lag_p99_ms']:.1f} ms; "
            f"raft_crc_rejected +{r['rejected']:.0f}; launches K5 {r['launched']['crc32c']} "
            f"K8 {r['launched']['crc32c_vote']} K7 {r['launched']['vote_tally']}")
    p = c["plane"]
    log(f"config 5 run C: the probing plane's decision {p['decision']} (None: every append under "
        f"PROBE_MIN_ROWS stayed on the host oracle), validations {p['validations']}, "
        f"rows_validated {p['rows_validated']}, probe {json.dumps(p.get('probe'))}")
    log(f"raft append ms: config 5's replicate median {a['p50_ms']:.3f} ms (run A) and "
        f"{b['p50_ms']:.3f} ms (run B) beside phase 6's plane-only "
        f"{NOTES.get('raft_plane_ms', float('nan')):.3f} ms per append of "
        f"{RAFT_PARTITIONS * RAFT_BATCHES} regions; the phase took "
        f"{time.perf_counter() - t_phase:.1f} s")
    return launches


# ------------------------------------------------------------------ config 5 through the controller
CONTROLLER_MOVES = 16  # partitions that each move one replica to the fourth broker
CONTROLLER_WAIT_S = 120.0  # the ceiling of each of phase 7e's waits
CONTROLLER_CMD_S = 60.0  # the timeout passed where the controller's API takes one
CONTROLLER_WIDTHS = [64 << k for k in range(11)]  # the plane's row widths, 64 B to 64 KiB


class ControllerNode(Config5Node):
    """One broker of phase 7e: Config5Node's storage, rpc server and group
    manager on the card, with the control plane a broker's start builds
    (the JAX package's app.py:311-398): the controller on raft group 0, its
    dispatcher and backend (with the leaders and shard tables, moves
    finished through the dispatcher), the leadership gossip, the cluster
    service on the rpc server, and a Broker wired to them. A
    DataPolicyTable is attached to the controller, where a broker attaches
    its own."""

    started = False  # the control plane's, not the rpc server's

    def add_services(self, proto) -> None:
        from redpanda_tpu_torch import rpc
        from redpanda_tpu_torch.cluster import (
            ClusterService,
            Controller,
            ControllerBackend,
            ControllerDispatcher,
            MetadataCache,
            MetadataDisseminationService,
            PartitionLeadersTable,
            ShardTable,
        )
        from redpanda_tpu_torch.cluster import commands as ccmds
        from redpanda_tpu_torch.cluster.metadata_dissemination import md_dissemination_service
        from redpanda_tpu_torch.kafka.server.broker import Broker, BrokerConfig
        from redpanda_tpu_torch.policy import DataPolicyTable
        from redpanda_tpu_torch.raft import VNode

        vnode = VNode(self.node_id, 0)
        self.controller = Controller(vnode, self.gm, self.connections)
        self.dispatcher = ControllerDispatcher(self.controller, self.connections)
        self.broker = Broker(BrokerConfig(node_id=self.node_id, data_dir=self.base_dir),
                             self.storage)
        self.leaders = PartitionLeadersTable()
        self.md = MetadataDisseminationService(
            self.node_id, self.leaders, self.controller.members, self.connections)
        self.backend = ControllerBackend(
            vnode, self.controller.topic_table, self.gm, self.broker.partition_manager,
            leaders_table=self.leaders, shard_table=ShardTable(),
            finish_move=lambda ntp, reps: self.dispatcher.replicate(
                ccmds.finish_moving_cmd(ntp, reps), timeout=CONTROLLER_CMD_S))
        self.gm.register_leadership_notification(
            lambda c: self.md.notify_leadership(c.ntp, c.leader_id, c.term))
        ClusterService(self.controller, self.dispatcher).register(proto)
        proto.register_service(rpc.ServiceHandler(md_dissemination_service, self.md))
        self.broker.topic_table = self.controller.topic_table
        self.broker.controller_dispatcher = self.dispatcher
        self.broker.controller_leader_fn = lambda: self.controller.leader_id
        self.broker.metadata_cache = MetadataCache(
            self.controller.topic_table, self.controller.members, self.leaders)
        self.policies = DataPolicyTable().attach(self.controller)

    async def start_control_plane(self, seeds) -> None:
        """Group 0 over the seed brokers, the backend's reconcile loop and the
        gossip, as a broker's start runs them."""
        self.started = True
        await self.controller.start(seeds)
        await self.backend.start()
        await self.md.start()

    async def stop(self):
        try:
            if self.started:
                await self.md.stop()
                await self.backend.stop()
                await self.controller.stop()
        finally:
            await super().stop()


def attribute_launches(plane, into: dict, lock) -> None:
    """Count each device-leg call of the pinned single-card plane (one K5
    launch) under the (node, group) of the append it validates (a test
    double around the plane's method; the kernel's own count is read
    apart)."""
    run = plane._run_device

    def counted(rows, lens, claimed):
        got = run(rows, lens, claimed)
        key = APPEND_AT.get()
        with lock:
            into[key] = into.get(key, 0) + 1
        return got

    plane._run_device = counted


async def controller_stable_leader(nodes, hold: bool = True):
    """tests/raft_stability.py's rule for group 0: a controller leader that
    held one election timeout in its term with an entry of its own term
    committed. Without ``hold`` a settled leader counts at once (once the
    first held)."""
    import asyncio

    t0, timeout_s = time.perf_counter(), CONFIG5_ELECTION_MS / 1000.0
    while True:
        if time.perf_counter() - t0 > CONTROLLER_WAIT_S:
            fail(f"config 5 through the controller: no stable controller leader within "
                 f"{CONTROLLER_WAIT_S:.0f} s")
        lead = next((n for n in nodes if n.started and n.controller.is_leader()), None)
        if lead is None:
            await asyncio.sleep(0.05)
            continue
        if not hold and lead.controller.consensus.leadership_settled():
            return lead, time.perf_counter() - t0
        term = lead.controller.consensus.term
        await asyncio.sleep(timeout_s)
        c = lead.controller.consensus
        if c.is_leader() and c.term == term and c.leadership_settled():
            return lead, time.perf_counter() - t0


def phase_controller(dev) -> dict:
    """Phase 7e: BASELINE config 5 through the controller (module
    docstring). Returns K5's launches on the path."""
    import asyncio
    import tempfile
    import threading

    import numpy as np

    from redpanda_tpu_torch import kernels
    from redpanda_tpu_torch.cluster import Broker as Member
    from redpanda_tpu_torch.cluster import TopicConfig, join_cluster
    from redpanda_tpu_torch.cluster import commands as ccmds
    from redpanda_tpu_torch.hashing.crc32c import crc32c
    from redpanda_tpu_torch.models import NTP
    from redpanda_tpu_torch.ops.transforms import filter_field_eq
    from redpanda_tpu_torch.raft import VNode, device_plane
    from redpanda_tpu_torch.raft.consensus import raft_crc_rejected

    t_phase = time.perf_counter()
    soft, hard, raised = config5_fd_limit()
    pool = config5_pool()
    by, by_lock = {}, threading.Lock()  # (node id, group) -> K5 launches for its appends
    out, lags, marks = {}, [], {}

    def launched(group0: bool, node=None) -> int:
        with by_lock:
            return sum(v for (nid, g), v in by.items()
                       if (g == 0) == group0 and (node is None or nid == node))

    def appends(nodes, group0: bool) -> int:
        return sum(n.appends0 if group0 else n.appends - n.appends0 for n in nodes)

    async def lag_probe():  # how late the loop's timers fire, by when they fired
        while True:
            t0 = time.perf_counter()
            await asyncio.sleep(0.01)
            t1 = time.perf_counter()
            lags.append((t1, t1 - t0 - 0.01))

    async def wait(pred, what: str, every: float = 0.1) -> float:
        t0 = time.perf_counter()
        while not pred():
            if time.perf_counter() - t0 > CONTROLLER_WAIT_S:
                fail(f"config 5 through the controller: {what} not within "
                     f"{CONTROLLER_WAIT_S:.0f} s")
            await asyncio.sleep(every)
        return time.perf_counter() - t0

    def leader_node(nodes, g):
        return next((n for n in nodes if (c := n.gm.consensus_for(g)) is not None
                     and c.is_leader()), None)

    async def main(d):
        nodes = [ControllerNode(i, os.path.join(d, f"n{i}"), dev) for i in range(CONFIG5_NODES)]
        joiner = ControllerNode(CONFIG5_NODES, os.path.join(d, f"n{CONFIG5_NODES}"), dev)
        everyone = nodes + [joiner]
        probe = None
        try:
            # every broker's rpc server listens from the start; the fourth
            # broker's control plane (its group 0, backend, gossip) starts
            # when it joins, in step 4
            for n in everyone:
                await n.start()
            for a in everyone:
                for b in everyone:
                    if a is not b:
                        a.connections.register(b.node_id, "127.0.0.1", b.server.port)
            pinned = device_plane.RaftDevicePlane(probe=False, device=dev)
            rng = np.random.default_rng(9)
            for w in CONTROLLER_WIDTHS:
                # each row width builds its step at its first call: made in a
                # follower's append (group 0's command batches are new widths,
                # a 256-partition create ~20 KB), that held the append past
                # the election timeout
                region = rng.bytes(w)
                if not pinned.validate([region], [crc32c(region)]).all():
                    fail(f"config 5 through the controller: the plane's warm-up at {w} B")
            device_plane.install_default_plane(pinned)
            device_plane.configure(crc_validate=True, vote_tally=True)
            attribute_launches(pinned, by, by_lock)
            kernels.reset_launches()  # the phase's path starts here
            rej0 = raft_crc_rejected.value
            probe = asyncio.ensure_future(lag_probe())
            seeds = [VNode(n.node_id, 0) for n in everyone]
            marks["start"] = t0 = time.perf_counter()
            for n in nodes:
                await n.start_control_plane(seeds)
            leader, _ = await controller_stable_leader(nodes)
            out["t_controller"] = time.perf_counter() - t0
            for n in nodes:  # the seed brokers register themselves
                await n.dispatcher.replicate(
                    ccmds.register_node_cmd(n.node_id, "127.0.0.1", n.server.port,
                                            "127.0.0.1", 9092 + n.node_id),
                    timeout=CONTROLLER_CMD_S)
            await wait(lambda: all(sorted(n.controller.members.node_ids()) == [0, 1, 2]
                                   for n in nodes), "the seed brokers' registration")
            # 1. create, through a broker that is not the controller leader
            leader, _ = await controller_stable_leader(nodes, hold=False)
            via = next(n for n in nodes if n is not leader)
            marks["create"] = t0 = time.perf_counter()
            await via.broker.create_topic(TopicConfig("config5", CONFIG5_GROUPS, CONFIG5_NODES))
            out["t_create_cmd"] = time.perf_counter() - t0
            md = via.controller.topic_table.get("config5")
            if len(md.assignments) != CONFIG5_GROUPS:
                fail(f"config 5 through the controller: {len(md.assignments)} assignments")
            ntp_of = {pa.group: pa.ntp for pa in md.assignments.values()}
            groups = sorted(ntp_of)
            out["groups"] = (groups[0], groups[-1])

            def view(n):
                m = n.controller.topic_table.get("config5")
                return None if m is None else {p: (list(pa.replicas), pa.group, pa.moving_to)
                                               for p, pa in m.assignments.items()}

            def hosts_its_replicas(n):
                m = n.controller.topic_table.get("config5")
                if m is None:
                    return False
                mine = [pa for pa in m.assignments.values() if n.node_id in pa.replicas]
                got = {ntp for ntp in n.broker.partition_manager.partitions()
                       if ntp.topic == "config5"}
                return (got == {pa.ntp for pa in mine}
                        and all(n.gm.consensus_for(pa.group) is not None for pa in mine))

            await wait(lambda: all(view(n) is not None for n in nodes), "the create on every node")
            if any(view(n) != view(via) for n in nodes):
                fail("config 5 through the controller: the nodes' topic tables differ")
            await wait(lambda: all(hosts_its_replicas(n) for n in nodes),
                       "every replica materialized", every=0.25)
            out["t_materialized"] = time.perf_counter() - t0
            hosted = sum(len(n.broker.partition_manager.partitions()) for n in nodes)
            if hosted != CONFIG5_NODES * CONFIG5_GROUPS:
                fail(f"config 5 through the controller: {hosted} replicas hosted, want "
                     f"{CONFIG5_NODES * CONFIG5_GROUPS}")
            stable, _ = await config5_stable_leaders(nodes, groups)
            out["t_stable"] = time.perf_counter() - t0
            out["terms0"] = {g: t for g, (_n, t) in stable.items()}
            out["spread"] = [sum(1 for n, _t in stable.values() if n is node) for node in nodes]

            def md_converged(n):
                for g, ntp in ntp_of.items():
                    lead = leader_node(nodes, g)
                    if lead is None or n.broker.metadata_cache.get_leader(ntp) != lead.node_id:
                        return False
                return True

            await wait(lambda: all(md_converged(n) for n in nodes), "converged metadata",
                       every=0.25)
            out["t_metadata"] = time.perf_counter() - t0
            # 2. a data policy through the dispatcher of a broker that is not the leader
            spec = filter_field_eq("level", "error").to_json()
            marks["policy"] = t0 = time.perf_counter()
            await via.dispatcher.replicate(ccmds.create_data_policy_cmd("config5", "errs", spec),
                                           timeout=CONTROLLER_CMD_S)
            await wait(lambda: all((p := n.policies.get("config5")) is not None
                                   and (p.name, p.spec_json) == ("errs", spec) for n in nodes),
                       "the data policy on every node")
            out["t_policy"] = time.perf_counter() - t0
            # 3. one round of config 5's data through each leader's Partition.replicate
            batches = {g: pool[i * CONFIG5_BATCHES:(i + 1) * CONFIG5_BATCHES]
                       for i, g in enumerate(groups)}
            leaders = await config5_leaders(nodes, groups)
            a0, ad = appends(nodes, True), appends(nodes, False)
            k0, kd, k5 = launched(True), launched(False), kernels.CRC32C.launches
            rej = raft_crc_rejected.value
            marks["round"] = time.perf_counter()
            r = out["round"] = await config5_round(
                nodes, leaders, batches, "7e round",
                partition_of=lambda n, g: n.broker.partition_manager.get(ntp_of[g]))
            r["appends0"], r["appends"] = appends(nodes, True) - a0, appends(nodes, False) - ad
            r["k5_0"], r["k5"] = launched(True) - k0, launched(False) - kd
            r["k5_total"] = kernels.CRC32C.launches - k5
            r["rejected"] = raft_crc_rejected.value - rej
            if r["rejected"]:
                fail(f"config 5 through the controller: {r['rejected']:.0f} batches rejected "
                     f"in the round")
            if r["k5_0"] + r["k5"] != r["k5_total"] or r["k5"] < r["appends"] or r["appends"] <= 0 \
                    or r["k5_0"] < r["appends0"]:
                fail(f"config 5 through the controller: the round's K5 launches {r['k5_total']} "
                     f"(group 0 {r['k5_0']}, data {r['k5']}) for {r['appends0']} group-0 and "
                     f"{r['appends']} data appends that carried batches")
            # 4. the fourth broker joins through a seed that is not the leader;
            #    then 16 partitions each move one replica to it
            marks["join"] = t0 = time.perf_counter()
            await joiner.start_control_plane(seeds)
            await wait(lambda: view(joiner) == view(via), "the joiner's replay of the controller log")
            leader, _ = await controller_stable_leader(nodes, hold=False)
            seed = next(n for n in nodes if n is not leader)
            await join_cluster(
                Member(joiner.node_id, "127.0.0.1", joiner.server.port, "127.0.0.1",
                       9092 + joiner.node_id),
                ("127.0.0.1", seed.server.port), joiner.connections,
                seed_node_hint=seed.node_id, timeout=CONTROLLER_CMD_S)
            await wait(lambda: all(n.controller.members.contains(joiner.node_id)
                                   for n in everyone), "the joiner registered everywhere")
            await joiner.md.pull_initial(seed.node_id)  # as a starting broker does
            out["t_join"] = time.perf_counter() - t0
            leader, _ = await controller_stable_leader(everyone, hold=False)
            step = CONFIG5_GROUPS // CONTROLLER_MOVES
            moves = {}
            for p in range(0, CONFIG5_GROUPS, step):
                pa = leader.controller.topic_table.get("config5").assignments[p]
                lead = leader_node(nodes, pa.group)
                victim = next(x for x in pa.replicas if lead is None or x != lead.node_id)
                moves[p] = (pa.group, victim, [x for x in pa.replicas if x != victim]
                            + [joiner.node_id])
            ja, jk = appends([joiner], False), launched(False, joiner.node_id)
            marks["move"] = t0 = time.perf_counter()
            for p, (_g, _victim, target) in moves.items():
                await leader.controller.move_partition_replicas(NTP("kafka", "config5", p), target)

            def moved(n):
                m = n.controller.topic_table.get("config5")
                return all(sorted(m.assignments[p].replicas) == sorted(t)
                           and m.assignments[p].moving_to is None
                           for p, (_g, _v, t) in moves.items())

            await wait(lambda: all(moved(n) for n in everyone), "the 16 moves finished")
            await wait(lambda: all(joiner.broker.partition_manager.get(ntp_of[g]) is not None
                                   and nodes[v].broker.partition_manager.get(ntp_of[g]) is None
                                   and nodes[v].gm.consensus_for(g) is None
                                   for g, v, _t in moves.values()),
                       "the joiner hosting the 16 and the dropped replicas gone")
            out["t_move"] = time.perf_counter() - t0
            if any(view(n) != view(joiner) for n in everyone) or not all(
                    hosts_its_replicas(n) for n in everyone):
                fail("config 5 through the controller: tables or hosted replicas differ after "
                     "the moves")
            for g, _v, target in moves.values():
                lead = leader_node(everyone, g)
                if lead is None:
                    fail(f"config 5 through the controller: moved group {g} has no leader")
                last = lead.gm.consensus_for(g).dirty_offset
                replicas = [n for n in everyone if n.node_id in target]
                await wait(lambda: all(n.gm.consensus_for(g).commit_index >= last
                                       for n in replicas), f"group {g}'s new replica catching up")
                logs = [await log_range(n.gm.consensus_for(g),
                                        n.gm.consensus_for(g).log.offsets().start_offset, last)
                        for n in replicas]
                if any(x != logs[0] for x in logs) or not logs[0]:
                    fail(f"config 5 through the controller: moved group {g}: a replica's range "
                         f"differs from its leader's")
            out["join_appends"] = appends([joiner], False) - ja
            out["join_k5"] = launched(False, joiner.node_id) - jk
            if out["join_appends"] <= 0 or out["join_k5"] < out["join_appends"]:
                fail(f"config 5 through the controller: the joiner's catch-up: "
                     f"{out['join_k5']} K5 launches for {out['join_appends']} appends")
            terms = {g: max(n.gm.consensus_for(g).term for n in everyone
                            if n.gm.consensus_for(g) is not None) for g in groups}
            out["elections_after"] = sum(terms[g] - out["terms0"][g] for g in groups)
            out["group0_terms"] = sorted({n.controller.consensus.term for n in everyone})
            # 5. delete, through a broker that is not the controller leader
            leader, _ = await controller_stable_leader(everyone, hold=False)
            via = next(n for n in everyone if n is not leader)
            dirs = [n.storage.log_mgr.get(ntp).dir for n in everyone
                    for ntp in n.broker.partition_manager.partitions()]
            hosts = {ntp: [n for n in everyone if n.broker.partition_manager.get(ntp)]
                     for ntp in ntp_of.values()}
            marks["delete"] = t0 = time.perf_counter()
            await via.broker.delete_topic("config5")
            await wait(lambda: all([c.group for c in n.gm.groups()] == [0]
                                   and not n.broker.partition_manager.partitions()
                                   for n in everyone), "every group removed", every=0.25)
            await wait(lambda: not any(os.path.exists(x) for x in dirs),
                       "the log directories removed")
            await wait(lambda: not any(n.leaders.get_leader(ntp) is not None
                                       for ntp, ns in hosts.items() for n in ns),
                       "the leaders-table entries of the brokers that hosted the partitions "
                       "removed")
            out["t_delete"] = time.perf_counter() - t0
            out["stale_elsewhere"] = sum(1 for ntp, ns in hosts.items() for n in everyone
                                         if n not in ns and n.leaders.get_leader(ntp) is not None)
            out["dirs"] = len(dirs)
            out["appends0"] = appends(everyone, True)
            out["appends"] = appends(everyone, False)
            out["k5_0"], out["k5"] = launched(True), launched(False)
            out["k5_total"] = kernels.CRC32C.launches  # ... and ends here
            out["rejected"] = raft_crc_rejected.value - rej0
            if out["k5_0"] + out["k5"] != out["k5_total"] or out["appends0"] <= 0 \
                    or out["k5_0"] < out["appends0"] or out["k5"] < out["appends"]:
                fail(f"config 5 through the controller: {out['k5_total']} K5 launches (group 0 "
                     f"{out['k5_0']}, data {out['k5']}) for {out['appends0']} group-0 and "
                     f"{out['appends']} data appends that carried batches")
            if out["rejected"]:
                fail(f"config 5 through the controller: raft_crc_rejected rose by "
                     f"{out['rejected']:.0f}")
            marks["end"] = time.perf_counter()
        finally:
            try:
                if probe is not None:
                    probe.cancel()
                for n in everyone:
                    await n.stop()
            finally:
                device_plane.configure(crc_validate=False, vote_tally=False)
                device_plane.reset_default_plane()
        return out

    with tempfile.TemporaryDirectory(prefix="chip-smoke-controller-") as d:
        out = asyncio.run(main(d))
    r = out["round"]
    steps = ["start", "create", "policy", "round", "join", "move", "delete", "end"]

    def late(a, b) -> str:
        xs = sorted(x for t, x in lags if marks[a] <= t < marks[b])
        if not xs:
            return "none"
        return f"max {xs[-1] * 1e3:.1f} p99 {xs[int(len(xs) * 0.99)] * 1e3:.1f} ms"

    log(f"config 5 through the controller ({CONFIG5_NODES} brokers + a fourth that joins, one "
        f"process, localhost TCP, election timeout {CONFIG5_ELECTION_MS:.0f} ms, heartbeat "
        f"{CONFIG5_HEARTBEAT_MS:.0f} ms, the pinned single-card plane; RLIMIT_NOFILE soft {soft} "
        f"hard {hard} (now {raised})): stable controller leader {out['t_controller']:.2f} s after "
        f"group 0 started; create_topic(config5, {CONFIG5_GROUPS} x rf {CONFIG5_NODES}) through a "
        f"non-leader broker returned in {out['t_create_cmd']:.2f} s (groups {out['groups'][0]}-"
        f"{out['groups'][1]}); from the command: every replica materialized "
        f"{out['t_materialized']:.2f} s, stable leaders {out['t_stable']:.2f} s (per node "
        f"{out['spread']}), converged metadata {out['t_metadata']:.2f} s; the data policy on every "
        f"node in {out['t_policy']:.2f} s")
    log(f"config 5 through the controller, the round: {r['n']} Partition.replicate calls of 1 "
        f"batch ({r['bytes'] / 1e6:.1f} MB) committed on every replica in {r['secs']:.3f} s = "
        f"{r['batches_per_s']:.1f} batches/s, {r['mb_per_s']:.1f} MB/s; raft_replicate_hist p50 "
        f"{r['p50_ms']:.3f} ms p99 {r['p99_ms']:.3f} ms (bucket bounds); {r['resent']} resent "
        f"({r['timed_out']} after raft's 10 s timeout) in {r['resent_groups']} groups; "
        f"{r['appends']} data appends carried batches, K5 {r['k5']} on them, group 0 "
        f"{r['appends0']} / {r['k5_0']}; raft_crc_rejected +{r['rejected']:.0f}")
    log(f"config 5 through the controller, join and moves: the fourth broker replayed the "
        f"controller log and joined through a non-leader seed in {out['t_join']:.2f} s; "
        f"{CONTROLLER_MOVES} moves of one replica each finished in {out['t_move']:.2f} s, the "
        f"joiner's catch-up {out['join_appends']} appends with {out['join_k5']} K5 launches, "
        f"each moved range byte-identical to its leader's; delete_topic through a non-leader "
        f"broker: {CONFIG5_GROUPS * CONFIG5_NODES} replicas, their groups and {out['dirs']} log "
        f"directories gone in {out['t_delete']:.2f} s, {out['stale_elsewhere']} gossiped "
        f"leaders-table entries left on brokers that never hosted the partition")
    log(f"config 5 through the controller, the phase: group 0 {out['appends0']} follower "
        f"appends with batches, {out['k5_0']} K5 launches on them; data groups "
        f"{out['appends']} / {out['k5']}; K5 {out['k5_total']} in all; "
        f"{out['elections_after']} data-group elections after the first stable view, group 0 "
        f"terms {out['group0_terms']}; the loop's timers late by "
        + "; ".join(f"{a} {late(a, b)}" for a, b in zip(steps, steps[1:]))
        + f"; the phase took {time.perf_counter() - t_phase:.1f} s")
    return {"crc32c": out["k5_total"]}


# ------------------------------------------------------------------ Kafka front door
KAFKA_C1_BATCHES = 4096  # phase 7f: config 1's batches of 16 x 1 KiB records (64 MiB)
KAFKA_C2_BATCHES = 256  # phase 7f: config 2's LZ4 batches a partition, 16 partitions
KAFKA_C2_PARTITIONS = 16
KAFKA_RECORDS, KAFKA_RECORD = 16, 1024  # a batch's records and a record's bytes
KAFKA_INFLIGHT = 8  # produce requests in flight on the one connection
KAFKA_POLICY_FETCHES = 4  # policy fetches of 1 MiB (~1000 records: K4's leg)


@functools.lru_cache(maxsize=1)
def card_line() -> str:
    """`nvidia-smi --query-gpu=name,power.limit` of the first card."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]


@functools.lru_cache(maxsize=1)
def kafka_text() -> bytes:
    """The text the records' pads are cut from: words with repeats."""
    import numpy as np

    words = np.array([b"error", b"warn", b"info", b"trace", b"x" * 16, b"kafka",
                      b"partition", b"leader"], dtype=object)
    return b" ".join(np.random.default_rng(70).choice(words, 1 << 19))


def kafka_batches(n: int, seed: int, compression=None) -> list:
    """``n`` batches of KAFKA_RECORDS JSON records of exactly KAFKA_RECORD
    bytes: a level (a third "error"), a code, a short msg and a text-like pad
    cut from one pool of words with repeats (so that LZ4 has something to
    find)."""
    import numpy as np

    from redpanda_tpu_torch.models import Compression, Record, RecordBatch

    pool = kafka_text()
    rng = np.random.default_rng(seed)
    levels = [b"error", b"info", b"warn"]
    out = []
    for i in range(n):
        recs = []
        for k in range(KAFKA_RECORDS):
            head = b'{"level":"%s","code":%d,"msg":"%s","pad":"' % (
                levels[(i + k) % 3], k - 5, b"m" * int(rng.integers(0, 90)))
            need = KAFKA_RECORD - len(head) - 2
            at = int(rng.integers(0, len(pool) - need))
            recs.append(Record(offset_delta=k, timestamp_delta=k,
                               value=head + pool[at:at + need] + b'"}'))
        out.append(RecordBatch.build(recs, first_timestamp=1_700_000_000_000 + i,
                                     compression=compression or Compression.none))
    return out


def produce_body(parts) -> dict:
    """A PRODUCE request at acks=-1: ``parts`` is [(topic, partition, wire bytes)]."""
    topics = {}
    for t, p, records in parts:
        topics.setdefault(t, []).append({"partition_index": p, "records": records})
    return {"transactional_id": None, "acks": -1, "timeout_ms": 30000,
            "topics": [{"name": t, "partitions": ps} for t, ps in topics.items()]}


def fetch_body(topic: str, offsets, max_bytes: int, isolation: int = 0) -> dict:
    return {"replica_id": -1, "max_wait_ms": 0, "min_bytes": 0, "max_bytes": max_bytes,
            "isolation_level": isolation, "session_id": 0, "session_epoch": -1,
            "topics": [{"name": topic, "partitions": [
                {"partition_index": p, "current_leader_epoch": -1, "fetch_offset": o,
                 "log_start_offset": -1, "partition_max_bytes": max_bytes}
                for p, o in offsets]}],
            "forgotten_topics_data": [], "rack_id": ""}


def phase_kafka(dev) -> dict:
    """Phase 7f: BASELINE configs 1 and 2 over the Kafka wire (module
    docstring). Returns K6's and K4's launches on the path."""
    import asyncio
    import tempfile

    from redpanda_tpu_torch import kernels
    from redpanda_tpu_torch.kafka.client import KafkaClient
    from redpanda_tpu_torch.kafka.protocol import messages as m
    from redpanda_tpu_torch.kafka.protocol.batch import encode_wire_batches
    from redpanda_tpu_torch.kafka.protocol.errors import ErrorCode
    from redpanda_tpu_torch.kafka.server import KafkaServer
    from redpanda_tpu_torch.kafka.server.broker import Broker, BrokerConfig
    from redpanda_tpu_torch.models import Compression
    from redpanda_tpu_torch.observability import probes
    from redpanda_tpu_torch.ops import crc_backend
    from redpanda_tpu_torch.policy import PolicyEngine
    from redpanda_tpu_torch.storage import StorageApi
    from redpanda_tpu_torch.utils.hdr import HdrHist

    t_phase = time.perf_counter()
    c1 = kafka_batches(KAFKA_C1_BATCHES + 1, seed=71)
    extra = c1.pop()  # (d)'s one request
    warm = kafka_batches(1, seed=79, compression=Compression.lz4)[0]  # config 2's first batch
    c2 = {p: kafka_batches(KAFKA_C2_BATCHES, seed=720 + p, compression=Compression.lz4)
          for p in range(KAFKA_C2_PARTITIONS)}
    wire1 = [encode_wire_batches([b]) for b in c1]
    wire2 = {p: [encode_wire_batches([b]) for b in bs] for p, bs in c2.items()}
    c2_bytes = sum(len(w) for ws in wire2.values() for w in ws)
    bad = bytearray(wire1[0])
    bad[61 + 100] ^= 0x20  # a byte of the first record
    log(f"Kafka front door: data made in {time.perf_counter() - t_phase:.1f} s "
        f"(config 1 {len(c1)} batches, {sum(map(len, wire1)) / 1e6:.1f} MB on the wire; "
        f"config 2 {KAFKA_C2_PARTITIONS} x {KAFKA_C2_BATCHES} LZ4 batches, "
        f"{c2_bytes / 1e6:.1f} MB on the wire for "
        f"{KAFKA_C2_PARTITIONS * KAFKA_C2_BATCHES * KAFKA_RECORDS * KAFKA_RECORD / 1e6:.1f} MB "
        "of records)")
    out = {}

    def check(resp, parts: int) -> list:
        got = [p for t in resp["responses"] for p in t["partitions"]]
        if len(got) != parts or any(p["error_code"] != 0 for p in got):
            fail(f"Kafka front door: a produce failed: {got}")
        return got

    async def produce_all(conn, bodies) -> tuple[list, float]:
        gate = asyncio.Semaphore(KAFKA_INFLIGHT)

        async def one(body):
            async with gate:
                return await conn.request(m.PRODUCE, body)

        t0 = time.perf_counter()
        resps = await asyncio.gather(*(one(b) for b in bodies))
        return resps, time.perf_counter() - t0

    async def fetch_all(client, topic: str, p: int, hwm: int) -> tuple[list, int]:
        got, offset, nbytes = [], 0, 0
        while offset < hwm:
            batches, _ = await client.fetch(topic, p, offset, max_bytes=8 << 20, max_wait_ms=0)
            if not batches:
                fail(f"Kafka front door: an empty fetch of {topic}/{p} at {offset} < {hwm}")
            got += batches
            nbytes += sum(len(encode_wire_batches([b])) for b in batches)
            offset = batches[-1].last_offset + 1
        return got, nbytes

    def same(produced, fetched, what: str) -> None:
        if len(produced) != len(fetched):
            fail(f"{what}: {len(fetched)} batches came back for {len(produced)}")
        for a, b in zip(produced, fetched):
            if (a.payload, a.header.crc, a.header.record_count) != (
                    b.payload, b.header.crc, b.header.record_count):
                fail(f"{what}: a fetched batch differs from the produced one")

    async def main(d):
        storage = await StorageApi(d).start()
        broker = Broker(BrokerConfig(data_dir=d), storage, device=dev)
        server = await KafkaServer(broker, "127.0.0.1", 0).start()
        broker.config.advertised_port = server.port
        client = await KafkaClient([("127.0.0.1", server.port)]).connect()
        try:
            await client.create_topic("config1", partitions=1)
            await client.create_topic("config2", partitions=KAFKA_C2_PARTITIONS)
            conn = await client.leader_connection("config1", 0)
            pinned = crc_backend.CrcBackend("device", device=dev)
            crc_backend.install_default_backend(pinned)
            # the warm-up: the validator's first launch at this width, off the clock
            check(await conn.request(m.PRODUCE, produce_body(
                [("config2", 0, encode_wire_batches([warm]))])), 1)

            # (a) config 1: one batch a request, KAFKA_INFLIGHT in flight
            probes.kafka_produce_hist.hist = HdrHist()
            kernels.reset_launches()  # (a)'s produce path starts here
            resps, secs = await produce_all(conn, [produce_body([("config1", 0, w)])
                                                   for w in wire1])
            bases = [check(r, 1)[0]["base_offset"] for r in resps]
            hwm = await client.latest_offset("config1", 0)
            resp = await conn.request(m.PRODUCE, produce_body([("config1", 0, bytes(bad))]))
            code = resp["responses"][0]["partitions"][0]["error_code"]
            k6 = path_launches("Kafka produce (config 1)", kernels.CRC32C_VALIDATE)
            h = probes.kafka_produce_hist.hist
            out["c1"] = {"secs": secs, "k6": k6["crc32c_validate"], "p50": h.percentile(50),
                         "p99": h.percentile(99), "bytes": sum(map(len, wire1)),
                         "requests": len(wire1), "batches": len(wire1)}
            if code != int(ErrorCode.corrupt_message):
                fail(f"Kafka front door: the flipped batch got error {code}, not corrupt_message")
            if await client.latest_offset("config1", 0) != hwm or hwm != len(c1) * KAFKA_RECORDS:
                fail("Kafka front door: the corrupt batch moved the high watermark")
            if sorted(bases) != [KAFKA_RECORDS * i for i in range(len(c1))]:
                fail("Kafka front door: config 1's base offsets are not 16 apart")
            if out["c1"]["k6"] != len(c1) + 1:
                fail(f"Kafka front door: K6 launched {out['c1']['k6']} times for "
                     f"{len(c1) + 1} produce requests of one partition")
            t0 = time.perf_counter()
            fetched, nbytes = await fetch_all(client, "config1", 0, hwm)
            out["c1"]["fetch_secs"], out["c1"]["fetch_bytes"] = time.perf_counter() - t0, nbytes
            by_base = sorted(zip(bases, c1), key=lambda x: x[0])
            same([b for _, b in by_base], fetched, "config 1")

            # (b) config 2: every request carries one LZ4 batch of each partition
            probes.kafka_produce_hist.hist = HdrHist()
            bodies = [produce_body([("config2", p, wire2[p][i]) for p in range(KAFKA_C2_PARTITIONS)])
                      for i in range(KAFKA_C2_BATCHES)]
            kernels.reset_launches()  # (b)'s produce path starts here
            resps, secs = await produce_all(conn, bodies)
            for r in resps:
                check(r, KAFKA_C2_PARTITIONS)
            k6 = path_launches("Kafka produce (config 2)", kernels.CRC32C_VALIDATE)
            h = probes.kafka_produce_hist.hist
            out["c2"] = {"secs": secs, "k6": k6["crc32c_validate"], "requests": len(bodies),
                         "batches": len(bodies) * KAFKA_C2_PARTITIONS,
                         "p50": h.percentile(50), "p99": h.percentile(99),
                         "bytes": sum(len(w) for b in bodies for t in b["topics"]
                                      for w in (p["records"] for p in t["partitions"]))}
            if out["c2"]["k6"] != len(bodies) * KAFKA_C2_PARTITIONS:
                fail(f"Kafka front door: K6 launched {out['c2']['k6']} times for "
                     f"{len(bodies)} requests of {KAFKA_C2_PARTITIONS} partitions")
            t0, nbytes = time.perf_counter(), 0
            for p in range(KAFKA_C2_PARTITIONS):
                hwm2 = await client.latest_offset("config2", p)
                fetched, nb = await fetch_all(client, "config2", p, hwm2)
                nbytes += nb
                same(([warm] if p == 0 else []) + c2[p], fetched, f"config 2 partition {p}")
            out["c2"]["fetch_secs"], out["c2"]["fetch_bytes"] = time.perf_counter() - t0, nbytes

            # (c) a data policy on config 1's topic: fetches of ~1000 records take K4
            spec = payload_spec().to_json()
            await broker.set_data_policy("config1", "errors_v1", spec)
            part = broker.get_partition("config1", 0)
            plain = PolicyEngine(device="cpu")
            step = hwm // KAFKA_POLICY_FETCHES
            asks = [(i * step, 1 << 20) for i in range(KAFKA_POLICY_FETCHES)] + [(5, 16 << 10)]
            kernels.reset_launches()  # (c)'s fetch path starts here
            views = []
            for offset, max_bytes in asks:
                resp = await conn.request(m.FETCH, fetch_body("config1", [(0, offset)], max_bytes))
                pr = resp["responses"][0]["partitions"][0]
                if pr["error_code"] != 0:
                    fail(f"Kafka front door: the policy fetch at {offset} failed: {pr}")
                views.append(pr["records"] or b"")
            big = sum(1 for _, mb in asks if mb >= 1 << 20)
            k4 = path_launches("Kafka policy fetch", kernels.PAYLOAD_TRANSFORM)
            out["k4"], out["policy_kept"] = k4["payload_transform"], 0
            if out["k4"] != big:
                fail(f"Kafka front door: K4 launched {out['k4']} times for {big} policy "
                     "fetches of 256 records or more")
            for (offset, max_bytes), got in zip(asks, views):
                batches = await part.make_reader(offset, max_bytes, max_offset=hwm - 1)
                view = plain.transform_batches(spec, batches)
                if got != encode_wire_batches(view):
                    fail(f"Kafka front door: the policy fetch at {offset} differs from the CPU "
                         "PolicyEngine's view")
                out["policy_kept"] += sum(b.header.record_count for b in view)
            await broker.delete_data_policy("config1")

            # (d) unpinned: the produce path picks its backend on first use
            crc_backend.install_default_backend(None)
            kernels.reset_launches()
            resp = await conn.request(m.PRODUCE, produce_body(
                [("config1", 0, encode_wire_batches([extra]))]))
            check(resp, 1)
            picked = crc_backend.default_backend(dev)
            out["pick"] = picked.decision
            out["pick_k6"] = kernels.CRC32C_VALIDATE.launches
            if out["pick_k6"] != 4 + (picked.backend == "device"):
                fail(f"Kafka front door: {out['pick_k6']} K6 launches for pick()'s probe "
                     f"and a request on the {picked.backend} backend")
        finally:
            crc_backend.install_default_backend(None)
            await client.close()
            await server.stop()
            await storage.stop()

    with tempfile.TemporaryDirectory(prefix="chip-smoke-kafka-") as d:
        asyncio.run(main(d))
    card = card_line()
    for name, c, unit in (("config 1", out["c1"], "1 batch (1 partition)"),
                          ("config 2", out["c2"], f"{KAFKA_C2_PARTITIONS} LZ4 batches")):
        log(f"Kafka front door {name} [{card}]: {c['requests']} PRODUCE requests of {unit}, "
            f"{KAFKA_INFLIGHT} in flight on one connection, acks=-1: {c['secs']:.3f} s = "
            f"{c['batches'] / c['secs']:.1f} batches/s, {c['bytes'] / c['secs'] / 1e6:.1f} MB/s "
            f"on the wire ({c['batches'] * KAFKA_RECORDS * KAFKA_RECORD / c['secs'] / 1e6:.1f} "
            f"MB/s of records); kafka_produce_hist p50 {c['p50'] / 1e3:.3f} ms p99 "
            f"{c['p99'] / 1e3:.3f} ms (bucket bounds); K6 {c['k6']} launches; fetched back "
            f"byte-identical at {c['fetch_bytes'] / c['fetch_secs'] / 1e6:.1f} MB/s")
    d = out["pick"]
    log(f"Kafka front door [{card}]: the flipped batch answered corrupt_message with no append; "
        f"{KAFKA_POLICY_FETCHES} policy fetches of 1 MiB and one of 16 KiB, {out['policy_kept']} "
        f"records kept, equal to PolicyEngine(device='cpu'), K4 {out['k4']} launches; unpinned "
        f"pick(): host {d.host_batches_per_sec:.1f} batches/s, device "
        f"{d.device_batches_per_sec:.1f} batches/s, chose {d.backend} (K6 {out['pick_k6']}); "
        f"the phase took {time.perf_counter() - t_phase:.1f} s")
    return {"crc32c_validate": out["c1"]["k6"] + out["c2"]["k6"] + out["pick_k6"],
            "payload_transform": out["k4"]}


# ------------------------------------------------------------------ exactly-once loop
EOS_PARTITIONS = 16  # config 2's partitions, in and out
EOS_BATCHES = 64  # phase 7g: config 2's LZ4 batches a partition (16 MiB of records in all)
EOS_MEMBERS = 2  # consumers in the group, each with its own transactional id
EOS_POLL_BATCHES = 2  # input batches a poll takes from each of a member's partitions
EOS_ABORT_EVERY = 8  # every 8th transaction of a member aborts and is polled again
EOS_POLICY_FETCHES = 4  # read_committed policy fetches of 1 MiB, one a partition (K4)


async def eos_state(broker, storage) -> dict:
    """What a restart must keep: the coordinator's transactions and pid
    block, each partition's high watermark, LSO and aborted ranges (its
    producer state machine), the group's committed offsets."""
    from dataclasses import astuple

    from redpanda_tpu_torch.storage import KeySpace

    co = broker.tx_coordinator
    await co._load()
    gm = await broker.group_coordinator.start()
    group = gm.get("eos")
    parts = {}
    for topic in ("eos-in", "eos-out"):
        for p in range(EOS_PARTITIONS):
            part = broker.get_partition(topic, p)
            stm = await broker.recovered_rm_stm(part)
            parts[(topic, p)] = (part.high_watermark, stm.last_stable_offset,
                                 [astuple(a) for a in stm._aborted])
    return {"txs": {k: v.to_dict() for k, v in sorted(co._txs.items())},
            "pid_block": storage.kvs.get(KeySpace.controller, b"id_allocator/next_block"),
            "partitions": parts,
            "offsets": {k: oc.offset for k, oc in sorted(group.offsets.items())} if group else None}


def phase_eos(dev) -> dict:
    """Phase 7g: an exactly-once read-process-write loop over the Kafka wire
    (module docstring). Returns K6's, K4's and K5's launches."""
    import asyncio
    import collections
    import tempfile

    from redpanda_tpu_torch import kernels
    from redpanda_tpu_torch.kafka.client import KafkaClient
    from redpanda_tpu_torch.kafka.client.consumer import GroupConsumer
    from redpanda_tpu_torch.kafka.client.producer import TransactionalProducer
    from redpanda_tpu_torch.kafka.protocol import messages as m
    from redpanda_tpu_torch.kafka.protocol.batch import decode_wire_batches, encode_wire_batches
    from redpanda_tpu_torch.kafka.protocol.errors import ErrorCode, KafkaError
    from redpanda_tpu_torch.kafka.server import KafkaServer
    from redpanda_tpu_torch.kafka.server.broker import Broker, BrokerConfig
    from redpanda_tpu_torch.models import Compression, RecordBatch
    from redpanda_tpu_torch.observability import probes
    from redpanda_tpu_torch.ops import crc_backend
    from redpanda_tpu_torch.policy import PolicyEngine
    from redpanda_tpu_torch.storage import LogConfig, StorageApi
    from redpanda_tpu_torch.utils.hdr import HdrHist

    t_phase = time.perf_counter()
    inputs = {p: kafka_batches(EOS_BATCHES, seed=740 + p, compression=Compression.lz4)
              for p in range(EOS_PARTITIONS)}
    warm = kafka_batches(1, seed=79, compression=Compression.lz4)[0]
    want = collections.Counter(r.value for bs in inputs.values() for b in bs for r in b.records())
    n_records = sum(want.values())
    if n_records != EOS_PARTITIONS * EOS_BATCHES * KAFKA_RECORDS or len(want) != n_records:
        fail("exactly-once loop: the input records are not all distinct")
    log(f"exactly-once loop: data made in {time.perf_counter() - t_phase:.1f} s "
        f"({EOS_PARTITIONS} x {EOS_BATCHES} LZ4 batches of {KAFKA_RECORDS} x {KAFKA_RECORD} B, "
        f"{n_records * KAFKA_RECORD / 2**20:.1f} MiB of records)")
    out = {"requests": 0, "committed": 0, "aborted": 0, "aborted_at": []}

    async def produce_input(client) -> float:
        """The idempotent producer's batches, config 2's LZ4 ones (its send()
        makes uncompressed batches: the same header, built here), each
        partition's in order, the 16 partitions at once."""
        prod = await TransactionalProducer(client).init()

        async def one(p):
            for b in inputs[p]:
                seq = prod._seqs.get(("eos-in", p), 0)
                batch = RecordBatch.build(b.records(), compression=Compression.lz4,
                                          first_timestamp=b.header.first_timestamp,
                                          producer_id=prod.producer_id,
                                          producer_epoch=prod.epoch, base_sequence=seq)
                await client.produce_batches("eos-in", p, [batch])
                prod._seqs[("eos-in", p)] = seq + b.header.record_count
                out["requests"] += 1

        t0 = time.perf_counter()
        await asyncio.gather(*(one(p) for p in range(EOS_PARTITIONS)))
        return time.perf_counter() - t0

    async def join_all(consumers) -> None:
        """Both members join at once, so that the new group's initial
        rebalance delay puts them in one generation, 8 partitions each."""
        await asyncio.gather(*(c.join() for c in consumers))
        owned = [p for c in consumers for p in c.assignment.get("eos-in", [])]
        if (sorted(owned) != list(range(EOS_PARTITIONS))
                or len({c.generation for c in consumers}) != 1):
            fail(f"exactly-once loop: the group did not settle: "
                 f"{[(c.generation, c.assignment) for c in consumers]}")

    async def member(cons, prod, hwm: dict) -> None:
        """Poll read_committed, write the records to the output partition of
        the same index inside a transaction, send the offsets to the group,
        commit; every EOS_ABORT_EVERY-th transaction aborts and its input is
        polled again."""
        mine = cons.assignment["eos-in"]
        pos = await cons.fetch_committed("eos-in", mine)
        pos = {p: max(o, 0) for p, o in pos.items()}
        n_tx = 0
        while any(pos[p] < hwm[p] for p in mine):
            polled = {}
            for p in mine:
                if pos[p] >= hwm[p]:
                    continue
                batches, _ = await cons.client.fetch("eos-in", p, pos[p], max_bytes=256 << 10,
                                                     max_wait_ms=0, isolation_level=1)
                polled[p] = batches[:EOS_POLL_BATCHES]
                if not polled[p]:
                    fail(f"exactly-once loop: an empty read_committed poll of eos-in/{p} "
                         f"at {pos[p]} < {hwm[p]}")
            n_tx += 1
            abort = n_tx % EOS_ABORT_EVERY == 0
            prod.begin()
            sent = []
            for p, batches in polled.items():
                values = [r.value for b in batches for r in b.records()]
                sent.append((p, await prod.send("eos-out", p, values)))
                out["requests"] += 1
            await prod.send_offsets("eos", {("eos-in", p): bs[-1].last_offset + 1
                                            for p, bs in polled.items()})
            if abort:
                await prod.abort()
                out["aborted"] += 1
                out["aborted_at"] += sent
                continue
            await prod.commit()
            out["committed"] += 1
            for p, bs in polled.items():
                pos[p] = bs[-1].last_offset + 1

    async def read_output(client, conn) -> tuple[collections.Counter, set]:
        """A fresh read_committed reader of every output partition: its
        records, and the base offsets of the batches it was shown. The
        next offset is the last batch's of the raw response (markers
        included), which the reader's view hides."""
        got, bases = collections.Counter(), set()
        for p in range(EOS_PARTITIONS):
            offset, hwm = 0, await client.latest_offset("eos-out", p)
            while offset < hwm:
                batches, _ = await client.fetch("eos-out", p, offset, max_bytes=8 << 20,
                                                max_wait_ms=0, isolation_level=1)
                resp = await conn.request(m.FETCH, fetch_body("eos-out", [(p, offset)], 8 << 20,
                                                              isolation=1))
                raw = decode_wire_batches(resp["responses"][0]["partitions"][0]["records"] or b"")
                if not raw:
                    fail(f"exactly-once loop: an empty read_committed fetch of eos-out/{p} "
                         f"at {offset} < {hwm}")
                got.update(r.value for b in batches for r in b.records())
                bases |= {(p, b.header.base_offset) for b in batches}
                offset = raw[-1].batch.last_offset + 1
        return got, bases

    async def lso_hwm(conn) -> list:
        resp = await conn.request(m.FETCH, fetch_body(
            "eos-out", [(p, 0) for p in range(EOS_PARTITIONS)], 1 << 10, isolation=1))
        return [(q["last_stable_offset"], q["high_watermark"])
                for q in resp["responses"][0]["partitions"]]

    async def main(d):
        storage = await StorageApi(d).start()
        broker = Broker(BrokerConfig(data_dir=d), storage, device=dev)
        server = await KafkaServer(broker, "127.0.0.1", 0).start()
        broker.config.advertised_port = server.port
        addr = [("127.0.0.1", server.port)]
        clients = [await KafkaClient(addr).connect() for _ in range(EOS_MEMBERS + 1)]
        consumers = []
        try:
            admin = clients[0]
            for topic in ("eos-in", "eos-out"):
                await admin.create_topic(topic, partitions=EOS_PARTITIONS)
            await admin.create_topic("eos-warm", partitions=1)
            pinned = crc_backend.CrcBackend("device", device=dev)
            crc_backend.install_default_backend(pinned)
            conn = await admin.leader_connection("eos-in", 0)
            # the warm-up: the validator's first launch at this width, off the clock
            resp = await conn.request(m.PRODUCE, produce_body(
                [("eos-warm", 0, encode_wire_batches([warm]))]))
            if resp["responses"][0]["partitions"][0]["error_code"] != 0:
                fail(f"exactly-once loop: the warm-up produce failed: {resp}")

            # the main path: the idempotent input, then the loop
            probes.kafka_produce_hist.hist = HdrHist()
            kernels.reset_launches()
            out["produce_secs"] = await produce_input(admin)
            hwm = {p: await admin.latest_offset("eos-in", p) for p in range(EOS_PARTITIONS)}
            if any(h != EOS_BATCHES * KAFKA_RECORDS for h in hwm.values()):
                fail(f"exactly-once loop: the input's high watermarks are {hwm}")
            consumers = [GroupConsumer(clients[1 + i], "eos", ["eos-in"], session_timeout_ms=60_000,
                                       heartbeat_interval_s=0.5) for i in range(EOS_MEMBERS)]
            t0 = time.perf_counter()
            await join_all(consumers)
            producers = [await TransactionalProducer(clients[1 + i], f"eos-tx-{i}").init()
                         for i in range(EOS_MEMBERS)]
            await asyncio.gather(*(member(c, pr, hwm) for c, pr in zip(consumers, producers)))
            out["loop_secs"] = time.perf_counter() - t0
            k = path_launches("exactly-once loop", kernels.CRC32C_VALIDATE)
            h = probes.kafka_produce_hist.hist
            out.update(k6=k["crc32c_validate"], p50=h.percentile(50), p99=h.percentile(99))
            if out["k6"] != out["requests"]:
                fail(f"exactly-once loop: K6 launched {out['k6']} times for {out['requests']} "
                     "produce requests of one partition each")

            # the checks, each a failure
            got, bases = await read_output(admin, conn)
            if got != want:
                missing, extra = want - got, got - want
                fail(f"exactly-once loop: the output holds {sum(got.values())} records for "
                     f"{n_records}: {sum(missing.values())} missing, {sum(extra.values())} extra")
            shown = set(out["aborted_at"]) & bases
            if shown:
                fail(f"exactly-once loop: {len(shown)} batches of aborted transactions were shown")
            pairs = await lso_hwm(conn)
            if any(lso != hw for lso, hw in pairs):
                fail(f"exactly-once loop: an output partition's LSO is not its high watermark: {pairs}")
            committed = await consumers[0].fetch_committed("eos-in", list(range(EOS_PARTITIONS)))
            if committed != hwm:
                fail(f"exactly-once loop: the group's offsets {committed} are not the input's "
                     f"high watermarks {hwm}")
            zombie = producers[0]
            fresh = await TransactionalProducer(clients[0], "eos-tx-0").init()
            if (fresh.producer_id, fresh.epoch) != (zombie.producer_id, zombie.epoch + 1):
                fail("exactly-once loop: re-initialising eos-tx-0 did not bump its epoch")
            zombie.begin()
            try:
                await zombie.send("eos-out", 0, [b"zombie"])
                fail("exactly-once loop: the zombie producer's send was accepted")
            except KafkaError as e:
                if e.code != ErrorCode.invalid_producer_epoch:
                    raise

            # K4: read_committed fetches of the output through a data policy
            spec = payload_spec().to_json()
            await broker.set_data_policy("eos-out", "errors_v1", spec)
            plain = PolicyEngine(device="cpu")
            kernels.reset_launches()
            views = []
            for p in range(EOS_POLICY_FETCHES):
                resp = await conn.request(m.FETCH, fetch_body("eos-out", [(p, 0)], 1 << 20,
                                                              isolation=1))
                pr = resp["responses"][0]["partitions"][0]
                if pr["error_code"] != 0:
                    fail(f"exactly-once loop: the policy fetch of eos-out/{p} failed: {pr}")
                views.append((p, pr["records"] or b""))
            out["k4"] = path_launches("exactly-once policy fetch",
                                      kernels.PAYLOAD_TRANSFORM)["payload_transform"]
            if out["k4"] != EOS_POLICY_FETCHES:
                fail(f"exactly-once loop: K4 launched {out['k4']} times for "
                     f"{EOS_POLICY_FETCHES} policy fetches of 256 records or more")
            out["policy_kept"] = out["policy_markers"] = 0
            for p, got_view in views:
                part = broker.get_partition("eos-out", p)
                batches = await part.make_reader(0, 1 << 20, max_offset=part.high_watermark - 1)
                view = plain.transform_batches(spec, batches)
                if got_view != encode_wire_batches(view):
                    fail(f"exactly-once loop: the policy fetch of eos-out/{p} differs from the "
                         "CPU PolicyEngine's view")
                out["policy_kept"] += sum(b.header.record_count for b in view)
                out["policy_markers"] += sum(b.header.is_control for b in batches)
            await broker.delete_data_policy("eos-out")
            before = await eos_state(broker, storage)
        finally:
            crc_backend.install_default_backend(None)
            for c in consumers:
                await c.leave()
            for c in clients:
                await c.close()
            await server.stop()
            await storage.stop()

        # the restart: storage reopened with device recovery, state unchanged
        kernels.reset_launches()
        t0 = time.perf_counter()
        storage = await StorageApi(d, LogConfig(base_dir=os.path.join(d, "data"),
                                                use_device_recovery=True,
                                                recovery_device=str(dev))).start()
        broker = Broker(BrokerConfig(data_dir=d), storage, device=dev)
        server = await KafkaServer(broker, "127.0.0.1", 0).start()
        try:
            after = await eos_state(broker, storage)
            out["restart_secs"] = time.perf_counter() - t0
            out["k5"] = kernels.CRC32C.launches
            for key in before:
                if after[key] != before[key]:
                    fail(f"exactly-once loop: the restart changed {key}")
            out["txs"] = {k: v["state"] for k, v in after["txs"].items()}
            out["aborted_ranges"] = sum(len(v[2]) for v in after["partitions"].values())
        finally:
            await server.stop()
            await storage.stop()

    with tempfile.TemporaryDirectory(prefix="chip-smoke-eos-") as d:
        asyncio.run(main(d))
    card = card_line()
    secs = out["loop_secs"]
    log(f"exactly-once loop [{card}]: config 2's {EOS_PARTITIONS} x {EOS_BATCHES} LZ4 batches "
        f"produced by an idempotent producer at acks=-1 in {out['produce_secs']:.3f} s; "
        f"{EOS_MEMBERS} consumers (range, {EOS_PARTITIONS // EOS_MEMBERS} partitions each) "
        f"read_committed, {out['committed']} committed and {out['aborted']} aborted "
        f"transactions in {secs:.3f} s = {out['committed'] / secs:.1f} committed transactions/s, "
        f"{n_records / secs:.1f} input records/s; kafka_produce_hist p50 {out['p50'] / 1e3:.3f} ms "
        f"p99 {out['p99'] / 1e3:.3f} ms (bucket bounds) over input and loop; K6 {out['k6']} "
        f"launches for {out['requests']} produce requests")
    log(f"exactly-once loop [{card}]: every input record once in the output, no batch of an "
        f"aborted transaction shown, LSO = high watermark on every output partition, the "
        f"group's offsets = the input's high watermarks, the zombie fenced; "
        f"{EOS_POLICY_FETCHES} read_committed policy fetches of 1 MiB, {out['policy_kept']} "
        f"records kept ({out['policy_markers']} control batches read, none kept), equal to "
        f"PolicyEngine(device='cpu'), K4 {out['k4']} launches; restart in "
        f"{out['restart_secs']:.3f} s with device recovery (K5 {out['k5']} launches), tx "
        f"states {out['txs']}, {out['aborted_ranges']} aborted ranges, pid block, LSOs and "
        f"offsets unchanged; the phase took {time.perf_counter() - t_phase:.1f} s")
    return {"crc32c_validate": out["k6"], "payload_transform": out["k4"], "crc32c": out["k5"]}


# ------------------------------------------------------------------ LZ4 phase
def phase_lz4(dev) -> tuple[dict, dict]:
    import numpy as np
    import torch

    from redpanda_tpu_torch import kernels
    from redpanda_tpu_torch.ops import lz4_device as L

    rng = np.random.default_rng(4)
    texts = L.text_records(400, 700, seed=5)
    encode, source = lz4_encoder()
    comp = [encode(t) for t in texts]
    log(f"LZ4 streams made with {source}")
    rows, lens = L.pack_streams(comp)
    lens[::9] //= 2  # truncated
    rows[4::13, 3] ^= 0x77  # damaged tokens, offsets and literals
    lens[5] = 0  # empty
    lens[6] = -4
    handmade = [bytes([0x14, 97, 0, 0, 0, 0]), bytes([0x10, 97, 2, 0, 0]), bytes([0x10, 97, 1, 0])]
    for k, h in enumerate(handmade):  # offset 0, offset past op, a stream ending in a match
        rows[7 + k] = 0
        rows[7 + k, : len(h)] = np.frombuffer(h, np.uint8)
        lens[7 + k] = len(h)
    garbage = rng.integers(0, 256, size=(100, rows.shape[1]), dtype=np.uint8)
    rows = np.concatenate([rows, garbage])
    lens = np.concatenate([lens, rng.integers(-2, rows.shape[1] + 9, 100).astype(np.int32)])
    c, cl = torch.from_numpy(rows).to(dev), torch.from_numpy(lens).to(dev)
    n_edge = len(lens)
    for max_out in (700, 256):  # 256: overflowing
        got, want = L.decode_rows(c, cl, max_out), L.decode_plain(c, cl, max_out)
        torch.cuda.synchronize()
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            fail(f"lz4_block kernel != plain (max_out {max_out})")
        log(f"K11 parity (max_out {max_out}): {len(lens)} streams, {int(want[2].sum())} ok, "
            "out/out_len/ok bit-identical to the plain version")
    edge_sets = []
    for max_out, pad in ((128, 0), (77, 3), (1024, 0), (49152, 0)):  # 49152: the global rows
        rows, lens = L.edge_streams(max_out, seed=max_out)
        rows = np.pad(rows, ((0, 0), (0, pad)))
        if max_out > 2048:  # every 11th offset/length pair and every other stream: the
            keep = np.r_[0 : 40 * 77 : 11, 40 * 77 : len(lens)]  # plain version runs
            rows, lens = rows[keep], lens[keep]  # max_out steps, on the host
        c, cl = torch.from_numpy(rows).to(dev), torch.from_numpy(lens).to(dev)
        t0 = time.perf_counter()
        got = [g.cpu() for g in L.decode_rows(c, cl, max_out)]
        want = L.decode_plain(c.cpu(), cl.cpu(), max_out)
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            fail(f"lz4_block kernel != plain on the edge streams (max_out {max_out})")
        slice_b = -(-rows.shape[1] // 16) * 16 + -(-max_out // 16) * 16
        where = "shared memory" if slice_b <= 48 * 1024 else "global rows"
        edge_sets.append(f"{max_out} ({where})")
        log(f"K11 edge streams (max_out {max_out}, rows of {rows.shape[1]}, a warp's slice "
            f"{slice_b} B: {where}): {len(lens)} streams, {int(want[2].sum())} ok, all three "
            f"outputs bit-identical to the plain version ({time.perf_counter() - t0:.1f} s "
            "with the plain run)")

    # config 2's produce batch: 16 partitions x 1024 text-like 1 KiB records
    records = L.text_records(LZ4_RECORDS, LZ4_RECORD, seed=6)
    rows, lens = L.pack_streams([encode(r) for r in records])
    decode = L.make_block_decoder(rows.shape[1], LZ4_RECORD, dev)
    decode(rows[:64], lens[:64])  # build and first launch
    kernels.reset_launches()  # the LZ4 path starts here
    t0 = time.perf_counter()
    out, out_len, ok = decode(rows, lens)
    t_dev = time.perf_counter() - t0
    probe = L.measure_probe(LZ4_RECORDS, LZ4_RECORD, reps=3, device=dev,
                            compress=encode)
    launches = path_launches("lz4", kernels.LZ4_BLOCK)  # the LZ4 path ends here
    if not ok.all() or not (out_len == LZ4_RECORD).all():
        fail("lz4 path: the decoder rejected valid streams")
    if out.tobytes() != b"".join(records):
        fail("lz4 path: a decoded row differs from its source")
    log(f"lz4 path (config 2): {LZ4_RECORDS} records of {LZ4_RECORD} B from "
        f"{int(lens.sum())} compressed B (rows of {rows.shape[1]}): decoded on the card in "
        f"{t_dev * 1e3:.2f} ms incl. copies, every row equal to its source; "
        f"measure_probe: {json.dumps(probe)}")
    c, cl = torch.from_numpy(rows).to(dev), torch.from_numpy(lens).to(dev)
    got = L.decode_rows(c, cl, LZ4_RECORD)
    want = L.decode_plain(c, cl, LZ4_RECORD)
    torch.cuda.synchronize()
    if not all(torch.equal(g, w) for g, w in zip(got, want)):
        fail("lz4_block kernel != plain at full width")
    ms = cuda_ms(lambda: L.decode_rows(c, cl, LZ4_RECORD), 20)
    plain_ms = cuda_ms(lambda: L.decode_plain(c, cl, LZ4_RECORD), 1)
    nbytes = int(lens.sum()) + 4 * len(lens) + LZ4_RECORDS * (LZ4_RECORD + 4 + 1)
    b_ms, b_by = bound_ms(nbytes, LZ4_RECORDS * LZ4_RECORD)
    log(f"K11 full width: kernel {ms:.4f} ms, plain {plain_ms:.1f} ms, bound "
        f"{b_ms * 1e3:.2f} us ({b_by}, {nbytes} B)")
    # time against the number of streams: flat while the SMs have room
    # (latency), linear once they are full (instruction throughput or bytes)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    by_n = {k: cuda_ms(lambda k=k: L.decode_rows(c[:k], cl[:k], LZ4_RECORD), 20)
            for k in (sms, 10 * sms, 48 * sms, LZ4_RECORDS)}
    log("K11 kernel ms by streams (" + ", ".join(f"{k}: {t:.4f}" for k, t in by_n.items())
        + f"; {sms} SMs)")
    m = {"max_abs_err": max_abs_err(list(zip(got, want))), "ms": ms, "plain_ms": plain_ms,
         "bound_ms": b_ms, "bound_by": b_by,
         "parity": f"out, out_len and ok bit-identical on {n_edge} damaged streams at max_out "
                   f"700 and 256, on the edge streams at max_out {', '.join(edge_sets)} and "
                   f"at full width {LZ4_RECORDS} x {LZ4_RECORD}"}
    return m, launches


# ------------------------------------------------------------------ mesh phases
def equal(got, want) -> bool:
    """Exact equality of a Sharded or tensor result with a tensor."""
    import numpy as np

    g = np.asarray(got) if not hasattr(got, "cpu") else got.cpu().numpy()
    return g.shape == tuple(want.shape) and (g == want.cpu().numpy()).all()


def config5_rows(seed: int):
    """config 5's append as [1024, 16384] rows: random bytes everywhere
    (garbage past each length), lengths just under 16 KiB, the claims
    right but for three, one row of length 0."""
    import numpy as np

    from redpanda_tpu_torch.hashing.crc32c import crc32c_many

    n = RAFT_PARTITIONS * RAFT_BATCHES
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, 256, size=(n, 16384), dtype=np.uint8)
    lens = rng.integers(15_000, 16385, n).astype(np.int32)
    lens[77] = 0
    claimed = crc32c_many(rows, lens)
    claimed[[3, n // 2, n - 1]] ^= 0x1
    return rows, lens, claimed


def step_inputs(seed: int):
    """K10 at full width: P partitions x 4 batch rows of 16384 (lengths
    just under 16 KiB, two claims wrong), P x 512 record rows of 1152 (the
    bench's JSON with short msgs, 16 copies of each partition's batch) and
    [P, 256] votes."""
    import numpy as np

    from redpanda_tpu_torch.coproc import batch_codec
    from redpanda_tpu_torch.hashing.crc32c import crc32c_many
    from redpanda_tpu_torch.ops.packing import pack_rows

    rng = np.random.default_rng(seed)
    b_rows = rng.integers(0, 256, size=(P * STEP_BATCHES, 16384), dtype=np.uint8)
    b_lens = rng.integers(15_000, 16385, P * STEP_BATCHES).astype(np.int32)
    claimed = crc32c_many(b_rows, b_lens)
    claimed[[5, -3]] ^= 0x8
    req = build_request(short_msgs=True, seed=seed)
    copies = STEP_RECORDS // RECORDS_PER_BATCH
    batches = [b for it in req.items for b in [it.batches[0]] * copies]
    ex = batch_codec.explode_batches(batches)
    values = [bytes(ex.joined[o : o + z]) for o, z in zip(ex.offsets, ex.sizes)]
    rec, rec_lens = pack_rows(values, ROW_STRIDE)
    votes = rng.integers(0, 2, (P, VOTE_GROUPS)).astype(np.uint8)
    return (b_rows.reshape(P, STEP_BATCHES, 16384), b_lens.reshape(P, STEP_BATCHES),
            claimed.reshape(P, STEP_BATCHES), rec.reshape(P, STEP_RECORDS, ROW_STRIDE),
            rec_lens.reshape(P, STEP_RECORDS), votes)


def on_card(a, dev):
    import numpy as np
    import torch

    return torch.from_numpy(np.ascontiguousarray(a.view(np.int32) if a.dtype == np.uint32 else a)).to(dev)


def phase_mesh_kernels(dev, mesh) -> tuple[dict, dict]:
    import numpy as np
    import torch

    from redpanda_tpu_torch import kernels
    from redpanda_tpu_torch.coproc import batch_codec
    from redpanda_tpu_torch.coproc.column_plan import (
        block_chunks, plan_spec, predicate_stacked_plain)
    from redpanda_tpu_torch.coproc.host_pool import partition_counts
    from redpanda_tpu_torch.coproc.engine import _bucket_rows
    from redpanda_tpu_torch.ops.crc32c_device import validate_segments
    from redpanda_tpu_torch.ops.exprs import host_eval
    from redpanda_tpu_torch.ops.transforms import compile_transform, where
    from redpanda_tpu_torch.parallel import collectives as COL
    from redpanda_tpu_torch.parallel import shard_to_mesh
    from redpanda_tpu_torch.parallel.mesh import card_chunks, card_groups

    D = mesh.size
    out, launches = {}, {}
    rng = np.random.default_rng(9)

    # K7: the vote tally over the mesh, and torch.sum beside it
    agg = COL.make_vote_aggregator(mesh)
    pairs = []
    for g in (VOTE_GROUPS, 1):
        votes = on_card(rng.integers(0, 2, (D, g)).astype(np.uint8), dev)
        got, want = agg(votes), COL.vote_tally_plain(votes)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            fail(f"vote_tally != plain over [{D}, {g}]")
        pairs.append((got, want))
    gen = torch.Generator(device=dev).manual_seed(13)
    n_calls, n_equal = 200, 0
    before = kernels.VOTE_TALLY.launches, COL.tally_copies
    for _ in range(n_calls):  # fresh votes made on the card just before each call
        votes = torch.randint(0, 2, (D, VOTE_GROUPS), generator=gen, device=dev,
                              dtype=torch.uint8)
        got = agg(votes)
        n_equal += bool(torch.equal(got, COL.vote_tally_plain(votes)))
    per_call = ((kernels.VOTE_TALLY.launches - before[0]) / n_calls,
                (COL.tally_copies - before[1]) / n_calls)
    if n_equal != n_calls:
        fail(f"vote_tally != plain on {n_calls - n_equal} of {n_calls} calls on fresh votes")
    host_votes = rng.integers(0, 2, (D, VOTE_GROUPS)).astype(np.uint8)
    if not torch.equal(agg(host_votes).cpu(), COL.vote_tally_plain(torch.from_numpy(host_votes))):
        fail(f"vote_tally != plain over host votes [{D}, {VOTE_GROUPS}]")
    # host votes, as the raft plane's tally_votes sends them: one H2D copy per card
    host_ms = cuda_ms(lambda: agg(host_votes), 200)
    votes = on_card(host_votes, dev)
    ms = cuda_ms(lambda: agg(votes), 200)
    one_ms = cuda_ms(lambda: COL.vote_tally(votes), 200)
    plain_ms = cuda_ms(lambda: COL.vote_tally_plain(votes), 200)
    lib_ms = cuda_ms(lambda: torch.sum(votes, 0, dtype=torch.int32), 200)
    b_ms, b_by = bound_ms(D * VOTE_GROUPS + 4 * VOTE_GROUPS, D * VOTE_GROUPS)
    log(f"K7 [{D}, {VOTE_GROUPS}]: aggregator {ms:.4f} ms on votes on the card ({per_call[0]:g} "
        f"launches and {per_call[1]:g} cross-card copies per call over {n_calls} calls, each equal "
        f"to the plain sum of fresh votes), {host_ms:.4f} ms on host numpy votes (one H2D copy "
        f"and one launch), one tally launch over the whole array {one_ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, torch.sum {lib_ms:.4f} ms, bound {b_ms * 1e3:.5f} us ({b_by})")
    out["vote_tally"] = {"max_abs_err": max_abs_err(pairs), "ms": ms, "plain_ms": plain_ms,
                         "library_ms": lib_ms, "bound_ms": b_ms, "bound_by": b_by,
                         "parity": f"bit-identical over [{D}, {VOTE_GROUPS}] and [{D}, 1] votes "
                                   f"and over {n_calls} calls on fresh votes"}

    # K9 and K8 over config 5's append: one launch a call on the one card
    rows, lens, claimed = config5_rows(10)
    n, r = rows.shape
    want_bad_total = 3
    rt, lt, ct = on_card(rows, dev), on_card(lens, dev), on_card(claimed, dev)
    check = COL.make_sharded_crc_check(mesh, r)
    p9 = (rt.view(RAFT_PARTITIONS, RAFT_BATCHES, r), lt.view(RAFT_PARTITIONS, RAFT_BATCHES),
          ct.view(RAFT_PARTITIONS, RAFT_BATCHES))
    kernels.reset_launches()  # the sharded CRC check's run starts here
    ok, bad = check(*p9)
    launches.update(path_launches("sharded CRC check", kernels.CRC32C_SHARDED))
    if launches["crc32c_sharded"] != len(card_groups(mesh.devices)):
        fail(f"sharded CRC check: {launches['crc32c_sharded']} launches, want one per card")
    w_ok, w_bad = COL.sharded_crc_plain(*p9)
    torch.cuda.synchronize()
    if not (equal(ok, w_ok) and equal(bad, w_bad)) or int(w_bad.sum()) != want_bad_total:
        fail("crc32c_sharded != plain over [256, 4, 16384]")
    valid = int(np.clip(lens, 0, r).sum())
    ms = cuda_ms(lambda: check(*p9), 50)
    k = n // D  # one shard's block alone: validate_segments, the one-block case
    one_ms = cuda_ms(lambda: validate_segments(rt[:k], lt[:k], ct[:k], RAFT_BATCHES,
                                               kernels.CRC32C_SHARDED), 50)
    shards9 = [(rt[d * k:(d + 1) * k], lt[d * k:(d + 1) * k], ct[d * k:(d + 1) * k], None)
               for d in range(D)]
    raw9, raw9_out = raw_crc_launch(kernels.CRC32C_SHARDED, shards9, r, RAFT_BATCHES,
                                    RAFT_PARTITIONS, 0, dev)
    raw9()
    torch.cuda.synchronize()
    if not (torch.equal(raw9_out[0], w_ok.view(-1)) and torch.equal(raw9_out[1], w_bad)):
        fail("rp_crc_blocks called directly != plain over [256, 4, 16384]")
    launch_ms = cuda_ms(raw9, 200)
    cold_ms = cuda_ms_cold(raw9, 50, dev)
    plain_ms = cuda_ms(lambda: COL.sharded_crc_plain(*p9), 1)
    b_ms, b_by = bound_ms(valid + 8 * n + n + 4 * RAFT_PARTITIONS, valid)
    lookups = 1.25 * valid  # slicing-by-8 and the 496-byte skip (csrc/crc32c.cuh)
    log(f"K9 [{RAFT_PARTITIONS}, {RAFT_BATCHES}, {r}] ({valid} valid B): {ms:.4f} ms a call over "
        f"{D} shards ({launches['crc32c_sharded']} launch); its launch alone {launch_ms:.4f} ms "
        f"with the rows in L2 ({valid / launch_ms / 1e6:.1f} GB/s, {lookups / launch_ms / 1e9:.2f} "
        f"T table lookups/s), {cold_ms:.4f} ms with L2 flushed before each launch; one shard's "
        f"block alone {one_ms:.4f} ms; plain {plain_ms:.2f} ms, bound {b_ms * 1e3:.3f} us "
        f"({b_by}); bad per partition sums to {int(w_bad.sum())}, the zero-length row neither "
        "ok nor bad")
    out["crc32c_sharded"] = {
        "max_abs_err": max_abs_err([(torch.from_numpy(np.asarray(ok)), w_ok.cpu()),
                                    (torch.from_numpy(np.asarray(bad)), w_bad.cpu())]),
        "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
        "launch_ms": launch_ms,
        "parity": "ok and bad per partition bit-identical over [256, 4, 16384] (three claims "
                  "wrong, a zero-length row, garbage past each length), on the edge set and "
                  "over 200 calls"}
    step8 = COL.make_crc_vote_step(mesh, r)
    p8 = (rt.view(D, n // D, r), lt.view(D, n // D), ct.view(D, n // D), votes)
    kernels.reset_launches()  # the CRC + vote step's run starts here
    got = step8(*p8)
    k8_launches = {"crc32c_vote": kernels.CRC32C_VOTE.launches,
                   "vote_tally": kernels.VOTE_TALLY.launches}
    if k8_launches != {"crc32c_vote": len(card_groups(mesh.devices)), "vote_tally": 0}:
        fail(f"crc32c_vote step: launches {k8_launches}, want one per card and no vote_tally")
    want = COL.crc_vote_plain(*p8)
    torch.cuda.synchronize()
    if not all(equal(g, w) for g, w in zip(got, want)):
        fail("crc32c_vote step != plain over [4, 256, 16384] with [4, 256] votes")
    ms = cuda_ms(lambda: step8(*p8), 50)
    shards8 = [blk[:3] + (votes[d:d + 1],) for d, blk in enumerate(shards9)]
    raw8, raw8_out = raw_crc_launch(kernels.CRC32C_VOTE, shards8, r, n // D, D, VOTE_GROUPS, dev)
    raw8()
    torch.cuda.synchronize()
    if not all(torch.equal(a, w.view(-1)) for a, w in zip(raw8_out, want)):
        fail("rp_crc_blocks with votes called directly != plain over [4, 256, 16384]")
    launch_ms = cuda_ms(raw8, 200)
    plain_ms = cuda_ms(lambda: COL.crc_vote_plain(*p8), 1)
    b_ms, b_by = bound_ms(valid + 8 * n + n + 4 * D + D * VOTE_GROUPS + 4 * VOTE_GROUPS, valid)
    log(f"K8 [{D}, {n // D}, {r}] + [{D}, {VOTE_GROUPS}] votes: {ms:.4f} ms a call (launches "
        f"{k8_launches}: the tally rides in the CRC launch), its launch alone {launch_ms:.4f} ms, "
        f"plain {plain_ms:.2f} ms, bound {b_ms * 1e3:.3f} us ({b_by})")
    out["crc32c_vote"] = {
        "max_abs_err": max_abs_err([(torch.from_numpy(np.asarray(g)) if not hasattr(g, "cpu")
                                     else g.cpu(), w.cpu()) for g, w in zip(got, want)]),
        "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
        "launch_ms": launch_ms,
        "parity": "ok, bad per shard and tally bit-identical over [4, 256, 16384] with [4, 256] "
                  "votes, on the edge set and over 200 calls"}
    crc_blocks_edges_and_loop(dev, mesh)

    # K2 over DOCS x EXPRS in 4 shards (one empty), then the bench's launch
    vals, exprs = docs_and_exprs()
    cuts = [(0, 7), (7, 7), (7, 13), (13, len(vals))]

    def stacks_for(plan, parts, values, n_blk):
        per = []
        for s, e in parts:
            if s == e:
                per.append(plan.zero_device_inputs(n_blk))
                continue
            v = values[s:e]
            joined = b"".join(v)
            offsets = np.cumsum([0] + [len(x) for x in v[:-1]]).astype(np.int64)
            sizes = np.array([len(x) for x in v], np.int32)
            per.append(plan.extract_device_inputs(joined, offsets, sizes, n_blk))
        return [np.stack(c) for c in zip(*per)]

    pairs = []
    for i, expr in enumerate(exprs):
        plan = plan_spec(where(expr))
        stacked = stacks_for(plan, cuts, vals, 8)
        got = plan.predicate_stacked(mesh, stacked)
        want = predicate_stacked_plain(plan, [on_card(a, dev) for a in stacked])
        torch.cuda.synchronize()
        if not equal(got, want):
            fail(f"predicate_stacked != plain on EXPRS[{i}]")
        oracle = np.array([host_eval(expr, v) for v in vals])
        bits = np.asarray(got)
        keep = np.concatenate([np.unpackbits(bits[d])[: e - s] for d, (s, e) in enumerate(cuts)])
        if not (keep.astype(bool) == oracle).all():
            fail(f"predicate_stacked != host oracle on EXPRS[{i}]")
        pairs.append((torch.from_numpy(bits), want.cpu()))
    req = build_request(short_msgs=False)
    batches = [b for it in req.items for b in it.batches] * GROUP
    plan = plan_spec(columnar_spec())
    ex, types, vs, ve = batch_codec.explode_and_find(batches, plan.flat_paths())
    cache = plan.make_cache_from_tables(ex, plan.flat_paths(), types, vs, ve)
    counts = [e - s for s, e in ex.ranges]
    starts = np.concatenate([[0], np.cumsum(counts)])
    rec_cuts = [(int(starts[s]), int(starts[e])) for s, e in partition_counts(counts, D)]
    n_blk = _bucket_rows(max(e - s for s, e in rec_cuts))
    cols = plan.extract_device_inputs(ex.joined, ex.offsets, ex.sizes, len(ex.sizes), cache)
    stacked = []
    for c, z in zip(cols, plan.zero_device_inputs(n_blk)):
        st = np.repeat(z[None], D, axis=0)
        for k, (s, e) in enumerate(rec_cuts):
            st[k, : e - s] = c[s:e]
        stacked.append(st)
    args = shard_to_mesh(mesh, *stacked)
    args = args if isinstance(args, tuple) else (args,)
    got = plan.predicate_stacked(mesh, args)
    want = predicate_stacked_plain(plan, [on_card(a, dev) for a in stacked])
    torch.cuda.synchronize()
    if not equal(got, want):
        fail("predicate_stacked != plain at the bench shape")
    pairs.append((torch.from_numpy(np.asarray(got)), want.cpu()))
    n_cols = len(stacked)
    chunks = sum(len(block_chunks(len(shards), n_cols)) for _, shards in card_groups(mesh.devices))
    before = kernels.PREDICATE_STACKED.launches
    ms = cuda_ms(lambda: plan.predicate_stacked(mesh, args), 200)
    per_call = (kernels.PREDICATE_STACKED.launches - before) / 201
    if per_call != chunks:
        fail(f"predicate_stacked made {per_call:g} launches a call, not {chunks} (card chunks)")
    st_cuda = [on_card(a, dev) for a in stacked]
    raw, raw_out = raw_predicate_launch(plan, [[a[d] for a in st_cuda] for d in range(D)], dev)
    raw()
    torch.cuda.synchronize()
    if not torch.equal(raw_out, want):
        fail("one rp_predicate_blocks launch over the bench blocks != plain")
    launch_ms = cuda_ms(raw, 200)
    block0 = [a[0] for a in st_cuda]
    one_ms = cuda_ms(lambda: plan.predicate(block0, kernels.PREDICATE_STACKED), 200)
    plain_ms = cuda_ms(lambda: predicate_stacked_plain(plan, st_cuda), 20)
    nbytes = sum(a.nbytes for a in stacked) + D * n_blk // 8
    b_ms, b_by = bound_ms(nbytes, D * n_blk * len(plan.program.code))
    log(f"K2 parity: {len(exprs)} DOCS x EXPRS cases over {D} shards (one empty) bit-identical "
        f"to the plain version and the host oracle; bench shape {D} x {n_blk} rows (range shard "
        f"{[e - s for s, e in rec_cuts]}): {ms:.4f} ms a call ({per_call:g} launch a call, "
        f"{chunks} card chunk(s)); one launch over the {D} blocks alone {launch_ms:.4f} ms; "
        f"the one-block predicate over shard 0 {one_ms:.4f} ms; plain {plain_ms:.4f} ms, "
        f"bound {b_ms * 1e3:.4f} us ({b_by}, {nbytes} B)")
    out["predicate_stacked"] = {
        "max_abs_err": max_abs_err(pairs), "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
        "bound_by": b_by, "launch_ms": launch_ms,
        "parity": f"bit-identical on {len(exprs)} EXPRS cases in {D} shards (one empty) and at "
                  f"the bench shape ({D} x {n_blk})"}

    # K10 at full width
    host_in = step_inputs(11)
    spec_json = payload_spec().to_json()
    step = COL.make_sharded_coproc_step(mesh, spec_json, 16384, ROW_STRIDE)
    prog = compile_transform(payload_spec(), ROW_STRIDE)
    dev_in = [on_card(a, dev) for a in host_in]
    step_chunks = len(card_chunks(mesh.devices, COL.MAX_STEP_SHARDS))
    kernels.reset_launches()  # the coproc step's run starts here
    got = step(*dev_in)
    launches.update(path_launches("coproc step", kernels.COPROC_STEP))
    others = {k.name: k.launches for k in kernels.KERNELS
              if k.launches and k is not kernels.COPROC_STEP}
    if launches["coproc_step"] != step_chunks or others:
        fail(f"the coproc step launched {launches['coproc_step']} fused kernels (want "
             f"{step_chunks}) and {others} besides")
    want = COL.coproc_step_plain(prog, *dev_in)
    torch.cuda.synchronize()
    g_ok, g_out, g_len, g_keep, g_tally = (np.asarray(x) if not hasattr(x, "cpu") else
                                           x.cpu().numpy() for x in got)
    w_ok, w_out, w_len, w_keep, w_tally = (w.cpu().numpy() for w in want)
    if not ((g_ok == w_ok).all() and (g_len == w_len).all() and (g_keep == w_keep).all()
            and (g_out[w_keep] == w_out[w_keep]).all() and (g_tally == w_tally).all()):
        fail("coproc step != plain at full width")
    if w_ok.all() or not w_keep.any():
        fail("coproc step inputs do not exercise a bad batch and a kept record")
    before = kernels.COPROC_STEP.launches
    ms = cuda_ms(lambda: step(*dev_in), 50)
    per_step = (kernels.COPROC_STEP.launches - before) / 51
    if per_step != step_chunks:
        fail(f"the coproc step made {per_step:g} launches a step, not {step_chunks}")
    raw, raw_outs = raw_step_launch(prog, dev_in, D, 16384, ROW_STRIDE, dev)
    raw()
    torch.cuda.synchronize()
    r_ok, r_out, r_len, r_keep, r_tally = (x.cpu().numpy() for x in raw_outs)
    kept = w_keep.reshape(-1)
    if not ((r_ok == w_ok.reshape(-1)).all() and (r_len == w_len.reshape(-1)).all()
            and (r_keep == kept).all() and (r_tally == w_tally).all()
            and (r_out[kept] == w_out.reshape(-1, prog.r_out)[kept]).all()):
        fail("one rp_coproc_step launch at full width != plain")
    launch_ms = cuda_ms(raw, 50)
    plain_ms = cuda_ms(lambda: COL.coproc_step_plain(prog, *dev_in), 1)
    b_lens, rec_lens = host_in[1], host_in[4]
    n_b, n_r = b_lens.size, rec_lens.size
    nbytes = (int(np.clip(b_lens, 0, 16384).sum()) + 9 * n_b  # K6
              + int(np.clip(rec_lens, 0, ROW_STRIDE).sum()) + 4 * n_r
              + n_r * (prog.r_out + 4 + 1)  # K3
              + host_in[5].size + 4 * VOTE_GROUPS)  # K7
    b_ms, b_by = bound_ms(nbytes, int(np.clip(b_lens, 0, 16384).sum()))
    log(f"K10 full width: [{P}, {STEP_BATCHES}, 16384] batches ({int((~w_ok).sum())} bad), "
        f"[{P}, {STEP_RECORDS}, {ROW_STRIDE}] records ({int(w_keep.sum())} kept), [{P}, "
        f"{VOTE_GROUPS}] votes: {ms:.4f} ms per step ({per_step:g} fused launch a step, no other "
        f"kernel); the fused launch alone {launch_ms:.4f} ms; plain {plain_ms:.1f} ms, bound "
        f"{b_ms * 1e3:.2f} us ({b_by}, {nbytes} B)")
    out["coproc_step"] = {
        "max_abs_err": max_abs_err([(torch.from_numpy(g_ok), torch.from_numpy(w_ok)),
                                    (torch.from_numpy(g_len), torch.from_numpy(w_len)),
                                    (torch.from_numpy(g_tally), torch.from_numpy(w_tally))]),
        "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
        "launch_ms": launch_ms,
        "parity": "ok, out_len, keep, tally and the kept rows' out bit-identical at full width"}
    return out, launches


def raw_predicate_launch(plan, blocks, dev):
    """One launch of rp_predicate_blocks over ``blocks`` with the C entry
    point called directly (no wrapper, not counted): (fn, its output)."""
    import ctypes

    import torch

    from redpanda_tpu_torch import kernels

    code, needles = plan.program.on(dev)
    n_pad, n_cols = blocks[0][0].shape[0], len(blocks[0])
    out = torch.empty((len(blocks), n_pad // 8), dtype=torch.uint8, device=dev)
    table = (ctypes.c_void_p * (len(blocks) * n_cols))(*[a.data_ptr() for b in blocks for a in b])
    argv = (table, len(blocks), n_cols, code.data_ptr(), code.shape[0], needles.data_ptr(), n_pad,
            None, out.data_ptr(), kernels.stream_handle(dev))
    fn = kernels.PREDICATE_STACKED.fn()

    def run():
        if fn(*argv) != 0:
            fail("rp_predicate_blocks refused its launch")

    return run, out


def raw_step_launch(prog, dev_in, n_shards, r_batch, r_rec, dev):
    """One launch of rp_coproc_step over the step's inputs on the card cut
    into ``n_shards`` blocks, the C entry point called directly (no
    wrapper, not counted): (fn, (ok, out, out_len, keep, tally))."""
    import ctypes

    import torch

    from redpanda_tpu_torch import kernels
    from redpanda_tpu_torch.ops.crc32c_device import kernel_tables_on

    p = dev_in[0].shape[0] // n_shards
    b, n, g = dev_in[0].shape[1], dev_in[3].shape[1], dev_in[5].shape[1]
    ok = torch.empty(n_shards * p * b, dtype=torch.bool, device=dev)
    out = torch.empty((n_shards * p * n, prog.r_out), dtype=torch.uint8, device=dev)
    out_len = torch.empty(n_shards * p * n, dtype=torch.int32, device=dev)
    keep = torch.empty(n_shards * p * n, dtype=torch.bool, device=dev)
    tally = torch.empty(g, dtype=torch.int32, device=dev)
    table = (ctypes.c_void_p * (6 * n_shards))(
        *[a[d * p:(d + 1) * p].data_ptr() for d in range(n_shards) for a in dev_in])
    desc, pats = prog.on(dev)
    argv = (table, n_shards, p * b, r_batch, kernel_tables_on(dev).data_ptr(), ok.data_ptr(),
            p * n, r_rec, out.data_ptr(), out_len.data_ptr(), keep.data_ptr(), prog.r_out,
            desc.data_ptr(), prog.n_filters, prog.mapper, prog.n_fields, pats.data_ptr(), p, g,
            tally.data_ptr(), kernels.stream_handle(dev))
    fn = kernels.COPROC_STEP.fn()

    def run():
        if fn(*argv) != 0:
            fail("rp_coproc_step refused its launch")

    return run, (ok, out, out_len, keep, tally)


def raw_crc_launch(kernel, blocks, r, seg, n_bad, g, dev):
    """One launch of rp_crc_blocks over ``blocks`` ((rows, lens, claimed,
    votes or None) on the card) with the C entry point called directly (no
    wrapper, not counted): (fn, (ok, bad, tally or nothing))."""
    import ctypes

    import torch

    from redpanda_tpu_torch import kernels
    from redpanda_tpu_torch.ops.crc32c_device import (
        kernel_tables_on, round_powers_on, sm_count, span_table_on, split_layout)

    rows = blocks[0][0].shape[0]
    ok = torch.empty(len(blocks) * rows, dtype=torch.bool, device=dev)
    bad = torch.empty(n_bad, dtype=torch.int32, device=dev)
    tally = torch.empty(g, dtype=torch.int32, device=dev)
    table = (ctypes.c_void_p * (4 * len(blocks)))(
        *[None if t is None else t.data_ptr() for b in blocks for t in b])
    wpr, span = split_layout(r, rows * len(blocks), sm_count(dev))
    rounds = round_powers_on(dev)
    argv = (table, len(blocks), rows, r, seg, wpr, span, kernel_tables_on(dev).data_ptr(),
            rounds.data_ptr(), rounds.shape[0], span_table_on(dev, span).data_ptr(), None,
            ok.data_ptr(), bad.data_ptr(), n_bad,
            0 if blocks[0][3] is None else blocks[0][3].shape[0], g,
            tally.data_ptr() if g else None, kernels.stream_handle(dev))
    fn = kernel.fn()

    def run():
        if fn(*argv) != 0:
            fail("rp_crc_blocks refused its launch")

    return run, (ok, bad, tally) if g else (ok, bad)


def cuda_ms_cold(fn, iters: int, dev) -> float:
    """Mean ms of ``fn`` with the L2 cache flushed before each call (a
    128 MB write between launches, outside the timed interval)."""
    import torch

    l2_flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    fn()
    total = 0.0
    for _ in range(iters):
        l2_flush.fill_(1)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / iters


def split_edge_rows(r: int, n: int, seed: int):
    """n rows of width r (random bytes everywhere, garbage past each
    length) at lengths on and around every span and round boundary of the
    split CRC kernel, 0, negative and past r, the rest random; three claims
    wrong."""
    import numpy as np

    from redpanda_tpu_torch.hashing.crc32c import crc32c_many
    from redpanda_tpu_torch.ops.crc32c_device import ROUND

    rounds = -(-r // ROUND)
    spans = sorted({-(-rounds // w) * ROUND for w in (2, 4, 8)})  # every split's spans
    marks = [0, -3, r + 5, 1, 15, 16, 17, r - 1, r]
    marks += [j * s + e for s in spans for j in range(1, r // s + 1) for e in (-1, 0, 1)]
    marks += [k * ROUND + e for k in range(1, r // ROUND + 1) for e in (-1, 0, 1)]
    marks = [x for x in marks if -3 <= x <= r + 5][:n]
    rng = np.random.default_rng(seed)
    lens = np.array(marks + [int(x) for x in rng.integers(0, r + 1, n - len(marks))], np.int32)
    rows = rng.integers(0, 256, size=(n, r), dtype=np.uint8)
    claimed = crc32c_many(rows, lens)
    live = np.flatnonzero(lens > 0)
    claimed[live[[1, len(live) // 2, -1]]] ^= 0x20
    return rows, lens, claimed


def crc_blocks_edges_and_loop(dev, mesh):
    """K9 and K8 on the virtual mesh against their plain versions on the
    edge set (64 rows of 16384, 8192 and 5000 bytes, split across 8, 4 and
    2 warps, and of 100, unaligned, one warp each) and over 200 K8 calls on
    inputs permuted and votes drawn on the card just before each call."""
    import torch

    from redpanda_tpu_torch import kernels
    from redpanda_tpu_torch.parallel import collectives as COL

    D = mesh.size
    for r in (16384, 8192, 5000, 100):
        rows, lens, claimed = split_edge_rows(r, 16 * D, seed=r)
        d, ln, cl = on_card(rows, dev), on_card(lens, dev), on_card(claimed, dev)
        votes = torch.randint(0, 2, (D, 33), device=dev, dtype=torch.uint8)
        p9 = (d.view(16, D, r), ln.view(16, D), cl.view(16, D))
        p8 = (d.view(D, 16, r), ln.view(D, 16), cl.view(D, 16), votes)
        ok, bad = COL.make_sharded_crc_check(mesh, r)(*p9)
        got8 = COL.make_crc_vote_step(mesh, r)(*p8)
        w_ok, w_bad = COL.sharded_crc_plain(*p9)
        want8 = COL.crc_vote_plain(*p8)
        torch.cuda.synchronize()
        if not (equal(ok, w_ok) and equal(bad, w_bad)) or int(w_bad.sum()) != 3:
            fail(f"crc32c_sharded != plain on the edge set at r={r}")
        if not all(equal(g, w) for g, w in zip(got8, want8)):
            fail(f"crc32c_vote != plain on the edge set at r={r}")
    r, n = 5000, 64
    rows, lens, claimed = split_edge_rows(r, n, seed=43)
    d, ln, cl = on_card(rows, dev), on_card(lens, dev), on_card(claimed, dev)
    base_ok = COL.sharded_crc_plain(d.view(n, 1, r), ln.view(n, 1), cl.view(n, 1))[0].view(n)
    step = COL.make_crc_vote_step(mesh, r)
    gen = torch.Generator(device=dev).manual_seed(17)
    n_calls, n_equal = 200, 0
    before = kernels.CRC32C_VOTE.launches
    for _ in range(n_calls):
        perm = torch.randperm(n, generator=gen, device=dev)
        votes = torch.randint(0, 2, (D, VOTE_GROUPS), generator=gen, device=dev,
                              dtype=torch.uint8)
        lp = ln[perm].view(D, n // D)
        ok, bad, tally = step(d[perm].view(D, n // D, r), lp, cl[perm].view(D, n // D), votes)
        w_ok = base_ok[perm].view(D, n // D)
        w_bad = (~w_ok & (lp > 0)).sum(1, dtype=torch.int32)
        n_equal += bool(equal(ok, w_ok) and equal(bad, w_bad)
                        and torch.equal(tally, COL.vote_tally_plain(votes)))
    per_call = (kernels.CRC32C_VOTE.launches - before) / n_calls
    if n_equal != n_calls or per_call != 1:
        fail(f"crc32c_vote over {n_calls} calls on fresh inputs: {n_equal} equal to the plain "
             f"answer, {per_call:g} launches a call")
    log(f"K9/K8 edge set (64 rows of 16384, 8192, 5000 and 100 B: 8, 4, 2 and 1 warps a row; "
        f"lengths 0, -3, r+5 and on every span and round boundary) bit-identical to the plain "
        f"versions; K8 over "
        f"{n_calls} calls on inputs made on the card: all equal, {per_call:g} launch a call")


def phase_engine_mesh(dev, mesh, engine_run) -> dict:
    from redpanda_tpu_torch import kernels
    from redpanda_tpu_torch.coproc.column_plan import block_chunks, plan_spec
    from redpanda_tpu_torch.coproc.engine import TorchEngine
    from redpanda_tpu_torch.parallel.mesh import card_groups

    spec = columnar_spec()
    # the shards' ladders run on the host-stage pool
    eng = TorchEngine(device=dev, **PIN_K1, mesh=mesh, mesh_probe=False, row_stride=ROW_STRIDE,
                      host_workers=4)
    if eng.enable_coprocessors([(1, spec.to_json(), ("bench",))]) != [0]:
        fail("enable on the mesh")
    run_stream(eng, engine_run["work"]["bench"], GROUP + 1)  # warm-up
    eng.reset_stats()
    warm_rows = eng.stats()["mesh"]["rows_per_device"]
    kernels.reset_launches()  # the engine's mesh lane starts here
    rates, st = {}, None
    for wname, req in engine_run["work"].items():
        n_ticks = TICKS if wname == "bench" else 2 * GROUP
        replies, rates[wname] = run_stream(eng, req, n_ticks)
        ref = engine_run["want"]["columnar", wname]
        for k, rep in enumerate(replies):
            if reply_bytes(rep) != ref[k % GROUP]:
                fail(f"mesh lane {wname}: reply {k} differs from the CPU engine's")
        if wname == "bench":
            st = eng.stats()  # the bench workload's stages, as phase 3 prints them
    launches = path_launches("engine mesh lane", kernels.PREDICATE_STACKED)
    if kernels.PREDICATE.launches:
        fail("the single-device predicate ran on the pinned mesh lane")
    n_mesh = eng.stats()["n_mesh_launches"]  # both workloads since the reset
    n_cols = len(plan_spec(spec).zero_device_inputs(8))  # column arrays a block reads
    chunks = sum(len(block_chunks(len(shards), n_cols)) for _, shards in card_groups(mesh.devices))
    if launches["predicate_stacked"] != n_mesh * chunks:
        fail(f"mesh lane: {launches['predicate_stacked']} stacked predicate launches for "
             f"{n_mesh} mesh launches of {chunks} card chunk(s) each")
    eng.shutdown()
    check_envelope("engine mesh lane", eng.stats())
    m = st["mesh"]
    m["rows_per_device"] = [a - b for a, b in zip(m["rows_per_device"], warm_rows)]
    if sum(m["rows_per_device"]) != st["n_records"] or st.get("n_failures_dispatch"):
        fail(f"mesh lane accounting: {m}, n_records {st['n_records']}")
    if not (st.get("t_mesh_ladder") and (st.get("t_shard_explode_find2")
                                         or st.get("t_shard_explode_find"))):
        fail(f"mesh lane: the pooled shard ladders did not run {lane_stats(st)}")
    stages = {k: round(v, 6) for k, v in sorted(st.items()) if k.startswith(("t_", "n_", "bytes_"))}
    single = engine_run["rates"]["columnar", "bench"][0]
    log(f"engine mesh lane (virtual mesh of {mesh.size} shards on one card), columnar bench: "
        f"{rates['bench']:.1f} record_batches/s against the single lane's {single:.1f} (phase 3); "
        f"short_msgs {rates['short_msgs']:.1f}; replies byte-identical to TorchEngine(cpu); "
        f"rows_per_device {m['rows_per_device']}; launches {launches}; shard ladders on the "
        f"pool ({st['host_workers']:.0f} workers): t_mesh_ladder {st['t_mesh_ladder']:.6f} s wall")
    busy = (st.get("t_dev_h2d", 0) + st.get("t_dev_kernel", 0) + st.get("t_dev_d2h", 0)) \
        * rates["bench"] / (TICKS * P)
    log(f"engine mesh lane bench stages: {json.dumps(stages)}; streams busy {busy:.2%} "
        "of the wall (sum of CUDA-event intervals over the cards' streams)")
    log(f"engine t_dispatch over the bench's {TICKS} ticks: mesh lane "
        f"{st.get('t_dispatch', 0):.6f} s "
        f"({launches['predicate_stacked']} stacked predicate launches for {n_mesh} mesh launches, "
        f"one per card chunk), single lane {engine_run['dispatch']['columnar']:.6f} s (phase 3)")
    probing = TorchEngine(device=dev, **PIN_K1, mesh=mesh, mesh_probe=True, row_stride=ROW_STRIDE)
    probing.enable_coprocessors([(1, spec.to_json(), ("bench",))])
    replies, _ = run_stream(probing, engine_run["work"]["bench"], GROUP)
    if any(reply_bytes(r) != engine_run["want"]["columnar", "bench"][k % GROUP]
           for k, r in enumerate(replies)):
        fail("probing mesh engine: a reply differs from the CPU engine's")
    pm = probing.stats()["mesh"]
    check_envelope("probing mesh engine", probing.stats())
    probing.shutdown()
    log(f"engine mesh probe (mesh_probe=True): decision {pm['decision']}, probe "
        f"{json.dumps(pm.get('probe'))}")
    return launches


def phase_raft_mesh(dev, mesh) -> dict:
    import numpy as np

    from redpanda_tpu_torch import kernels
    from redpanda_tpu_torch.raft.device_plane import RaftDevicePlane, _host_validate

    n = RAFT_PARTITIONS * RAFT_BATCHES
    batches = random_batches(n, RAFT_RECORDS, RAFT_VALUE, 2)
    regions = [b.crc_region() for b in batches]
    claimed = np.array([b.header.crc for b in batches], np.uint32)
    claimed[[3, n // 2, n - 1]] ^= 0x1
    want = _host_validate(regions, claimed)
    plane = RaftDevicePlane(mesh=mesh, probe=False, device=dev)
    plane.validate(regions[:64], claimed[:64])  # first launches
    votes = np.random.default_rng(12).integers(0, 2, (mesh.size, VOTE_GROUPS)).astype(np.uint8)
    kernels.reset_launches()  # the raft mesh leg starts here
    t0 = time.perf_counter()
    ok = plane.validate(regions, claimed)
    t_dev = time.perf_counter() - t0
    tally = plane.tally_votes(votes)
    launches = path_launches("raft mesh leg", kernels.CRC32C_VOTE, kernels.VOTE_TALLY)
    t0 = time.perf_counter()
    for _ in range(200):  # each call returns the tally on the host
        plane.tally_votes(votes)
    t_tally = (time.perf_counter() - t0) / 200
    if not np.array_equal(ok, want) or ok.sum() != n - 3:
        fail("raft mesh leg: flags differ from the host oracle's")
    if not np.array_equal(tally, votes.astype(np.int32).sum(axis=0)):
        fail("raft mesh leg: tally_votes differs from the numpy sum")
    if launches["crc32c_vote"] != 1:
        fail(f"raft mesh leg: {launches['crc32c_vote']} crc32c_vote launches for one append")
    # the mesh leg beside the single-device leg, in turns, on the same append
    single = RaftDevicePlane(probe=False, device=dev)
    single.validate(regions[:64], claimed[:64])
    times = {"mesh": [], "single": []}
    for _ in range(5):
        for name, pl in (("mesh", plane), ("single", single)):
            t0 = time.perf_counter()
            flags = pl.validate(regions, claimed)
            times[name].append(time.perf_counter() - t0)
            if not np.array_equal(flags, want):
                fail(f"raft {name} leg: flags differ from the host oracle's")
    med = {k: sorted(v)[len(v) // 2] * 1e3 for k, v in times.items()}
    log(f"raft mesh leg (virtual mesh of {mesh.size} shards on one card): {n} regions of rows "
        f"16384, {t_dev * 1e3:.3f} ms per append ({n / t_dev:.1f} batches/s incl. pack and "
        f"copies); flags equal to the host oracle's; tally_votes [{mesh.size}, {VOTE_GROUPS}] "
        f"equal to the numpy sum, {t_tally * 1e3:.4f} ms a call host to host (mean of 200); "
        f"launches {launches}")
    log(f"raft append, median of 5 in turns on the same append: mesh leg {med['mesh']:.3f} ms, "
        f"single-device leg {med['single']:.3f} ms (ratio {med['mesh'] / med['single']:.3f})")
    return launches


def phase_dryrun(dev) -> dict:
    from redpanda_tpu_torch import entry, kernels

    kernels.reset_launches()  # dryrun_multichip starts here
    entry.dryrun_multichip(MESH_SHARDS, devices=[dev] * MESH_SHARDS)
    launches = path_launches("dryrun_multichip", kernels.PREDICATE_STACKED, kernels.COPROC_STEP)
    if launches["coproc_step"] != 1 or launches["predicate_stacked"] != 1:
        fail(f"dryrun_multichip on one card: {launches}, want one launch of each")
    log(f"dryrun_multichip({MESH_SHARDS}) on the virtual mesh: its asserts held; launches "
        f"{launches}")
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from redpanda_tpu_torch import kernels

    from redpanda_tpu_torch.compression import codecs

    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on {torch.cuda.get_device_name(0)}")
    zstd = ("zstandard" if codecs.zstandard is not None
            else "libzstd via ctypes" if codecs.zstd_available() else "none (output degrades to gzip)")
    log(f"zstd codec: {zstd}")
    t0 = time.perf_counter()
    builds = kernels.build_all()
    log(f"built kernels in {time.perf_counter() - t0:.2f} s: "
        + ", ".join(f"{k} {s:.2f} s" for k, s in builds.items()))
    for k in kernels.KERNELS:
        ptxas = [ln.strip() for ln in k.build_log().splitlines() if "registers" in ln or "spill" in ln]
        log(f"  {k.name}: {' | '.join(ptxas)}")
    measured = {"predicate": phase_predicate(dev)}
    measured["payload_transform"], measured["payload_record"] = phase_payload(dev)
    launches, engine_run = phase_engine(dev)
    lane_launches = phase_host_ladder(dev, engine_run)
    launches["predicate"] += sum(lane_launches.values()) + phase_pool(dev, engine_run)
    phase_fault_envelope(dev, engine_run)
    for name, n in phase_admission(dev, engine_run).items():
        launches[name] += n
    launches["predicate"] += phase_columnar_backend(dev, engine_run)
    for name, n in phase_recorders(dev, engine_run).items():
        launches[name] += n
    phase_sandbox(dev, engine_run)
    launches["payload_transform"] += phase_policy(dev)
    launches.update(phase_payload_entry(dev))
    measured.update(phase_crc_kernels(dev))
    launches.update(phase_produce(dev))
    crc_paths = [phase_raft(dev), phase_recovery(dev), phase_restart(dev)]
    launches["crc32c"] = sum(p["crc32c"] for p in crc_paths)
    for name, n in phase_runtime(dev).items():
        launches[name] += n
    config5_launches = phase_config5(dev)
    launches["crc32c"] += config5_launches["crc32c"] + phase_controller(dev)["crc32c"]
    for name, n in phase_kafka(dev).items():
        launches[name] += n
    for name, n in phase_eos(dev).items():
        launches[name] += n
    measured["lz4_block"], lz4_launches = phase_lz4(dev)
    launches.update(lz4_launches)
    from redpanda_tpu_torch.parallel import partition_mesh

    mesh = partition_mesh(devices=[dev] * MESH_SHARDS)
    log(f"virtual mesh: {mesh} (four streams of one card; nothing here measures "
        "scaling across cards)")
    mesh_measured, mesh_launches = phase_mesh_kernels(dev, mesh)
    measured.update(mesh_measured)
    engine_launches = phase_engine_mesh(dev, mesh, engine_run)
    raft_launches = phase_raft_mesh(dev, mesh)
    dry_launches = phase_dryrun(dev)
    phase_device_times(dev)
    launches["predicate_stacked"] = engine_launches["predicate_stacked"]
    launches["crc32c_vote"] = raft_launches["crc32c_vote"] + config5_launches["crc32c_vote"]
    launches["crc32c_sharded"] = mesh_launches["crc32c_sharded"]
    launches["vote_tally"] = raft_launches["vote_tally"] + config5_launches["vote_tally"]
    launches["coproc_step"] = mesh_launches["coproc_step"] + dry_launches["coproc_step"]
    line = []
    for k in kernels.KERNELS:
        m = measured[k.name]
        row = {
            "name": k.name, "route": "cuda", "source": k.source, "replaces": k.replaces,
            "launches": launches[k.name], "max_abs_err": m["max_abs_err"], "ms": m["ms"],
            "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"], "bound_by": m["bound_by"],
            "library_ms": m.get("library_ms"), "parity": m["parity"],
        }
        for extra in ("launch_ms", "device_ms", "leg_ms", "host_ms"):
            if extra in m:
                row[extra] = m[extra]
        line.append(row)
    log(f"every phase passed in {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": line}))
    log(card_line())
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
