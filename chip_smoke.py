#!/usr/bin/env python3
"""Smoke run of wfsim_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure ends the run with a non-zero exit and no result line):

1. device: needs ``torch.cuda.is_available()``; prints the nvidia-smi
   name/power-limit line, the torch and CUDA versions and ``nvcc --version``;
2. build: compiles ``wfsim_tpu_torch/csrc/*.cu`` into
   ``build/wfsim_tpu_torch/libkernels.so`` (nvcc, sm_90a) and prints the
   seconds and the ptxas resource lines;
3. kernels: each hand-written kernel against its plain PyTorch twin on the
   card, at main-path shapes (16 windows x 494 rows x 2048 samples, S2-like
   photons): bitwise equality required (3j times the superposition, 3k
   the ZLE and the record pack);
4. main path: ``Simulator(default_config(seed=1234, chunk_size=100),
   device='cuda').get_arrays(inst)`` on the 512-event bench workload, once
   to warm up and once timed with the kernels' launch counts reset just
   before; checks the truth and the strax invariants of the records;
   then the device's busy share of a warm run (device_busy: the union of
   the profiler's device records over the median wall of three runs);
5. cross-check: one window batch of that workload digitized on the card and
   by the twins on the CPU, records bitwise equal.

Then the realistic configuration (noise overlay, PMT afterpulses, electron
afterpulses; the JAX package's ``bench.py`` "production realism" line):

3b. kernels at realistic shapes, bitwise against their twins on the card:
    the PMT-afterpulse generator (select, rows, emit) on ~1.5 M S2-like
    photons with the synthetic tables (3l times it), the photon summaries
    (3m times them), and ``superpose_adc`` with the noise bank and offsets
    that wrap its end (3j times it);
4b. main path: ``Simulator(default_config(..., enable_noise=True,
    enable_pmt_afterpulses=True, enable_electron_afterpulses=True),
    device='cuda').get_arrays(inst)`` on the same workload, warm-up then
    timed, with the launch counts of every kernel on that path; checks the
    truth (type-4 rows included), the afterpulse photon fraction, the strax
    invariants and the noise on quiet in-window samples;
5b. cross-check: one realistic window batch, with its afterpulse pieces and
    noise offsets, on the card and by the CPU twins, records bitwise equal.

3j. the superposition entries, each bitwise against its twin on three
    window batches of 16 windows (SUPERPOSE_SHAPES: the bench batch; a
    skewed one whose window 0 holds one S2 of 10^6 photons, ~2,000 a row;
    a long one of 8195 samples): the slim grid (K1+K2), the slim grid with
    the realistic noise bank and wrapping offsets (K10), the full XENONnT
    grid (801-wide synthetic bank, factor 1) and the XENON1T grid without
    HE rows; each wrapper reads back at most once a call (counted under
    ``set_sync_debug_mode('warn')``); ``ms``, ``device_ms``, ``host_us``
    over 1,000 calls, the twin's time, the bound and two library
    computations (SUPERPOSE_LIBRARY: ``conv1d`` of a gain histogram, the
    taps through ``index_add_``), each with its time, its kernels' device
    times, its samples that differ from the twin's and its peak memory
    (none gated); the fastest is the row's ``library_ms``.

3k. the ZLE interval search (K3) and the record pack (K4, its count pass,
    the cumsum, one read-back and the copy) on the slim grids of the three
    3j batches and on the bench batch's full XENONnT grid (801 rows, the
    801-wide bank, ZLE's nonneg mode), each bitwise against its twin
    (sentinel slots included), K3 reading nothing back and K4 once a call
    (``set_sync_debug_mode('warn')``); ``ms``, ``device_ms`` (split by
    kernel), ``host_us`` over 1,000 calls, the twin's time and the bound:
    the in-window samples of the rows with photons, the row inputs and the
    interval slots for K3; the samples the records read, the records and
    their meta, the row inputs and the slots in use for K4.  Each K3 and
    K4 entry launches once a digitize batch on the default run.

3w. the arena gather and channel extents (K17, ``window_photons``: a
    batch's photons through its piece table in row order with each row's
    extents) on the 3j bench batch, its skewed copy (window 0 one S2 of
    10^6 photons) and the default run's largest digitize batch (its real
    arena, pieces and dropped photons): bitwise against its twin on every
    output, one launch and no read-back a call (counted, then once under
    ``set_sync_debug_mode('error')``); ``ms``, ``device_ms`` (its two
    passes, count and place; the call's device records with the table's
    copy beside), ``host_us`` over 1,000 calls, the twin's time, the bound
    (each table photon's channel, time and gain read once, the kept
    photons' time and gain written once, the table and the rows' outputs)
    and, as library call, one stable ``torch.sort`` of the batch's row
    keys alone; each device time beside the first design's
    (PARENT_DEVICE_MS).  K17 launches once a digitize batch on every
    configuration, as the ZLE (expect_records; EXPECTED_LAUNCHES).

3l. the PMT-afterpulse generator (K11: select, one cumsum, rows, one
    read-back, emit) on the 3b shape (1.5 M photons over 512 truth rows)
    and on a skewed copy whose truth row 100 holds 10^6 of them, and the
    diffused pattern (K12b) on the detector_physics S2 batch (512
    instructions, ~90 k electrons) and on a skewed copy whose instruction
    100 has 10^5 electrons: each bitwise against its twin, K11 reading
    back once a call and K12b never (``set_sync_debug_mode('warn')``);
    ``ms``, ``device_ms`` split by kernel, ``host_us`` over 1,000 calls,
    the twin's time and the bound (K11's bytes: the uniforms of every
    slot, the photon fields select reads, the selected slots' inputs,
    table entries and outputs; the old count of every input and output is
    printed beside it).  K11's entries launch 9 times on the realistic run,
    K12b's 3 times on the detector_physics run (EXPECTED_LAUNCHES).

3m. the luminescence tables (K6: block scans where a row's float64 sums
    are exact in any order, a sequential pass elsewhere) on 512 rows of
    the default gas gap (the 3c S2 batch's tables), on 512 rows of gaps
    uniform between the wire and the gate, and on 512 rows of constants
    whose light-weighted sum fails the exactness test (LUMI_SEQUENTIAL_BAR),
    and the photon summaries (K11 summaries: valid tiles, one cumsum,
    summaries) on the 3b shape and on its skewed copy (one truth row of
    10^6 photons): each bitwise against its twin, K6's rows on its
    sequential pass in one call held to its twin's count (0, 0 and 512),
    read-backs counted (0 for both), ``ms``, ``device_ms`` split by
    kernel, ``host_us`` over 1,000 calls, the twin's time and the bound
    (K6: the grids, the output and the twin's arithmetic inside each
    row's gap; the summaries: the valid flags, a sector of truth rows a
    row boundary, the sectors of t the candidates read, u and the
    outputs; the old counts printed beside).  K6 launches 3 times on the
    default run and the two summary entries 3 times each on the
    realistic run (EXPECTED_LAUNCHES); after 3m, every configuration's
    run and the phases after it leave K6's count of sequential rows at 0.

3n. the row kernel (K8 row truth: a warp, or for long rows a block, a
    row's first chunk of photons and a tile of the batch past it, pieces
    combined by integer atomics) on the default run's S1 batch
    (~7 k photons in 512 rows), its S2 electron times (~90 k, no channels),
    its S2 photons (~1.57 M) and a copy whose truth row 100 holds 10^6
    photons with the times of one large S2 (TRUTH_SKEWED_ROW), and the
    per-PMT kernel (K16) on that S2 batch (494 channels), the XENON1T one
    (248) and the skewed copy: each against its twin (counts bitwise,
    moments and areas within rtol 1e-12), the same bits on a second call,
    read-backs counted (0 for both), its rows on the float64 second pass
    in one call held to ``row_truth_second_pass_ref`` (0 on these
    batches), ``ms``, ``device_ms`` split by kernel, ``host_us`` over
    1,000 calls, the twin's time, the bound (the photon fields read once,
    the edges, the tables and the outputs) and a library computation held
    against the twin (``torch.segment_reduce`` for K8, one ``index_add_``
    for K16).  Every configuration's run leaves the second-pass counts at
    0 (``expect_no_second_pass``).

3o. the gas-gap luminescence times (K13a: a block an instruction of up
    to 8,192 photons; a larger one listed and cut into tiles, whose sums
    combine by integer atomics in a sum pass, then an apply pass) on the
    detector_physics S2 batch (~1.57 M photons in 512 instructions) and a
    copy whose instruction 100 holds 10^6 photons, and the S2 photon times
    (K9: tiles of photons, each photon's electron and instruction from a
    scan of the edges inside its tile) on the default run's S2 batch (the
    simple model's tables; ~90 k electrons, ~1.57 M photons), on the
    detector_physics one (given gas-gap times) and on PHOTON_SKEWED's batch
    (~2.4 M photons: one instruction of 10^6 photons, one electron of 10^5
    among them, three instructions without electrons, a tenth of the
    electrons without photons), with the S2 electron times of the default
    and the skewed batch, and the S1 photon times (K9 S1: a block an
    instruction's first 256 photons, tiles of 256 for the rest) on
    the default run's S1 batch, on its copy whose instruction 100 holds
    10^5 photons (S1_SKEWED; fresh draws) and on the timing_models and
    detector_physics S1 batches given their custom and NEST delays: each
    bitwise against its twin, the same bits on a second call, read-backs
    counted (0 for K13a and K9, the S1 times included; then once under
    ``set_sync_debug_mode('error')``), ``ms``, ``device_ms`` split by
    kernel, ``host_us`` over 1,000 calls, the twin's time and the bound
    (each input read once and each output written once; the old count,
    with the segment ids the kernels no longer write, printed beside).

3p. the custom S1 delays (K15) on the timing_models S1 batch (~7 k
    photons in 512 instructions, recoils cycling ER, NR, alpha, LED) and
    the NEST S1 delays (K13b) on the detector_physics one, each also on a
    copy whose instruction 100 holds 10^5 photons, an alpha S1 at a few
    MeV (S1_SKEWED; fresh draws): each bitwise against its twin, the same
    bits on a second call, no read-back (counted, then once under
    ``set_sync_debug_mode('error')``), ``ms``, ``device_ms`` from the
    entry's own records, ``host_us`` over 1,000 calls, the twin's time and
    the bound (K15: the classes, the edges, the draws of each photon's
    class and the delays; K13b: the per-instruction inputs, the edges, u,
    the table rows of the batch's corners and the delays).

3u. the round ordering (``round_order``, csrc/round_order.cu: the
    windows' counts by a search of each batch's window column, then a
    block a window, and one more for each 4,096 records of a longer
    window, ranking its records by (start, channel)) and the
    record rows (K4r: a round's records as strax raw_record rows in their
    sorted slots, read from the batches where they lie) on the default
    run's first round (~282 k records in 342 windows): the ordering's
    perm, windows and counts bitwise against its plain version (the
    packed-key ``torch.sort``), K4r bitwise against its twin and against
    the library composition (the rows built in torch, then one
    ``index_select``: two calls), no read-back in either, ``ms``,
    ``device_ms``, ``host_us`` over 1,000 calls, the plain versions'
    times, the bounds (the ordering: each record's window, start and
    channel read once, its place and window written once; K4r: each
    record's samples, meta, window and permutation entry read once, the
    windows' edges, 244 bytes a row written once), the library sort's and
    ``round_records``' times, each device time beside its parent's
    (PARENT_DEVICE_MS); then the round's rows into the host three ways
    (the record arena's, through its pinned staging buffer; into a
    page-locked base; a pageable synchronous copy), each bitwise; then
    the ordering on a round with a window of 10^5 records and on the
    he_full_grid run's first round, bitwise, its device time beside the
    library sort's, with each round's largest window and start and the
    windows on each of the kernel's paths (order_round_measure).
    The ordering and K4r launch once a digitize round on every
    configuration (EXPECTED_LAUNCHES); config_runs (``ab_port.py
    --configs``) prints each configuration's rounds' windows the same way
    from its warm-up run (``[windows]``).

Then the physics passes (S1, S2 and the PMT response) of the default
configuration, on the bench workload's 512 S1 and 512 S2 instructions as
one batch each, with their draws made on the card:

3c. each physics kernel against its twin on the card, with median
    CUDA-event times of both: the channel draw (~1.57 M S2 photons over 512
    rows, and a skewed copy: one row of 10^6 photons, three without
    photons, two without mass; each also with its host time a call and
    once under the sync check), the luminescence tables of 512
    instructions (against the twin on the card and on the CPU; 3m times
    them), the S1 photon, S2 electron and S2 photon
    time passes, the PMT photon pass and the row kernel (truth sums and
    time statistics); outputs bitwise equal, the float64 raw-area sums
    within rtol 1e-12;
5c. cross-check: the S1 and the S2 batch through the kernels on the card
    and, with the same draws copied to the CPU, through the CPU twins:
    photons bitwise equal, truth exact for the integer-valued fields and
    within rtol 1e-12 for the float sums.

Then the ``detector_physics`` configuration (NEST S1 timing, garfield
gas-gap luminescence, transverse diffusion 5e-8 cm^2/ns, AFT smearing,
inverse FDC with a constant dummy map, an S2 pattern map written from a
seed into a temporary directory in straxen's regular-grid JSON layout) on
the bench workload with ``local_field`` = 82 V/cm and ``e_dep`` = amp x
13.7 eV on every instruction:

3d. each new kernel against its twin on the card, with median CUDA-event
    times of both: the map lookup (1,024 points, on the 3-d FDC map with
    one output and on the 30 x 30 x 494 file pattern map; the S2 batch's
    512 instruction positions on the pattern map; 1.57 M points on a
    synthetic 50 x 50 x 100 map, the optical splines' photon width; each
    with its host time a call, then once under the sync check) and the
    gas-gap luminescence times (~1.5 M photons); max |diff| must be 0 (3l
    holds the diffused pattern, 3p the NEST delays);
4d. main path: ``Simulator(default_config(seed=1234, chunk_size=100,
    **detector_physics_overrides(map)), device='cuda').get_arrays(inst)``,
    warm-up then timed with the launch counts reset just before; every new
    entry point launched; one-off host costs (NEST table build, map read);
5d. cross-check: that workload's S1 and S2 batches through the kernels on
    the card and, from the same draws, through the twins on the CPU:
    photons bitwise equal, truth exact or within rtol 1e-12.

Then the ``he_full_grid`` configuration: the realistic switches, the three
resource files of a production configuration (an 801-channel noise bank,
the PMT-afterpulse CDFs and an SPE spectrum csv, written from a seed into
a temporary directory by ``write_production_files``) and a high-energy
deamplification factor of 1, so every digitize batch runs the full
XENONnT digitizer grid (494 TPC rows, 253 HE copies, the bottom-array sum
row; 801 rows a window):

3e. ``superpose_adc_full`` against its twin on the card, bitwise, at 16
    windows x 801 rows x 2048 samples with the 801-wide bank and offsets
    that wrap it, and the ZLE kernel in its full-grid mode on that grid;
4e. main path: ``Simulator(default_config(seed=1234, chunk_size=100,
    **he_full_grid_overrides(dir)), device='cuda').get_arrays(inst)``,
    warm-up then timed; launches of every kernel on the path (the
    full-grid entry once per digitize batch, the slim one never), records
    per split; ``raw_records_he`` non-empty and within 5 % of the
    top-array TPC record count, ``raw_records_aqmon`` empty;
5e. cross-check: one full-grid window batch on the card and by the CPU
    twins, records bitwise equal.

Then the ``timing_models`` configuration: the ``custom`` S1 timing model
(a delay by recoil class) and the ``garfield`` S2 luminescence model (a
wire-distance table, written from a seed into a temporary directory by
``write_garfield_table`` with three liquid levels, the nearest one read)
on the bench workload with the recoil ids cycling ER, NR, alpha, LED over
the events:

3f. ``lumi_garfield_times`` (garfield_measure) on the 512-instruction S2
    batch (~1.57 M photons), in its wire-rotation mode and in its confine
    mode, and on a copy whose instruction 100 holds 10^6 photons
    (GARFIELD_SKEWED), each against its twin on the card, bitwise, also
    against a library computation around one gather and on a second call,
    with no read-back; median CUDA-event times, device times, host
    microseconds a call, the bound by bytes (3p holds the custom delays);
4f. main path: ``Simulator(default_config(seed=1234, chunk_size=100,
    **timing_models_overrides(file)), device='cuda').get_arrays(inst)``,
    warm-up then timed; every entry point of the path launched (the two
    new ones included, the simple luminescence tables never); truth rows
    by type, the S1 photon-time mean by recoil class with NR below ER, a
    positive photon time spread on every S2 truth row with photons;
5f. cross-check: the S1 and S2 batches through the kernels on the card
    and, from the same draws, through the twins on the CPU: photons
    bitwise equal, truth exact or within rtol 1e-12.

Then the ``field_maps`` configuration: the S1 and S2 optical propagation
splines (S1 ``optical_propagation+simple``, S2 ``optical_propagation``),
COMSOL field distortion, gas-gap warping of the ``simple`` luminescence,
every field-dependency map (drift speed with ``norm_drift_velocity``,
survival, longitudinal and transverse diffusion) and the se-gain and
extraction maps, each map written from a seed into a temporary directory
by ``write_field_maps``, on the bench workload (phase_field_maps):

3q. the map lookup (K12a) at its new call sites (the S1 spline at the S1
    batch's ~6.9 k photons, the S2 spline at the S2 batch's ~1.3 M
    photons, the drift-speed and COMSOL (r, z) maps and the gas-gap and
    se-gain (x, y) maps at the 512 S2 instructions) and the luminescence
    tables (K6) with each S2 instruction's gas gap, each against its twin
    on the card, bitwise, timed beside ``grid_sample`` (the lookups) and
    with host microseconds a call; the S1 and S2 passes read back no more
    a batch than the default configuration's;
4q. main path: ``Simulator(default_config(seed=1234, chunk_size=100,
    **field_maps_overrides(dir)), device='cuda').get_arrays(inst)``,
    warm-up then timed; every entry of the path launched (the diffused
    pattern included); the mean electron positions inside the
    interactions' radius by COMSOL, the electrons within the maps'
    extraction;
5q. cross-check: the S1 and S2 batches through the kernels on the card
    and, from the same draws, through the twins on the CPU.

Then per-PMT truth and the XENON1T detector, each with the realistic
switches on the bench workload: ``per_pmt_truth`` (XENONnT, 494-wide
vectors per truth row) and ``xenon1t_full_grid`` (XENON1T: 248 TPC
channels, 127 of them top, deamplification factor 1, so every digitize
batch runs the full 801-row grid without HE rows, plus per-PMT truth):

3g. the per-PMT kernel (K16) against its twin on the 512-instruction S2
    batch of each configuration, after the PMT photon pass (~1.57 M
    photons, 494 and 248 channels): counts bitwise, raw areas within rtol
    1e-12; median CUDA-event times of both and of the library
    computation around one ``index_add_`` (per_pmt_library: the photons'
    six terms, the index, the sums and the casts inside the timed call),
    which is held against the twin too;
4g. main path: the per_pmt_truth run, warm-up then timed with every
    launch count set to 0 before it; every realistic entry and the
    per-PMT one launched; records bitwise those of the same run without
    per-PMT truth, whose bottom-array fields the vectors' bottom channels
    sum to (as the vectors sum to the row totals);
3h. ``superpose_adc_full`` without HE rows against its twin, bitwise, at
    16 windows x 801 rows x 2048 samples with the XENON1T bank and offsets
    that wrap it (rows 248-800 all 0); the bench positions checked against
    the configured TPC;
4h. main path: the xenon1t_full_grid run, warm-up then timed; the
    full-grid entry once per digitize batch, the slim one never, the
    per-PMT one launched; no ``raw_records_he`` key, every record on
    channels 0-247; records and truth bitwise those of the same run on
    the slim grid (factor 0) at the same framing (``split_digitize_gap_ns``
    0, which a non-zero factor implies), records bitwise those of the run
    without per-PMT truth, the vectors' sums as in 4g;
5h. one window batch without HE rows on the card and by the CPU twins,
    records bitwise equal.

Then the multi-device path (K14 and ``Simulator(mesh=...)``), on the one
card: ranks that share it talk over gloo, and NCCL runs at world size 1
(NCCL refuses two ranks on one device, so NCCL across two cards is not
exercised here):

3i. ``superpose_block`` (the channel block of the step) against its twin
    on the card, bitwise: the photons of one step shard (64 instructions
    of ``step_instructions``: 32 bench S1s and 32 bench S2s placed in a
    2^16-sample grid; the in-grid share is printed) on 494 channels in 2
    blocks of 247 and (step_block_measure) in 1 block, as is and with row
    300 holding 10^5 photons (STEP_SKEW: spread like the shard's photons,
    or in one ~300 ns burst), each also on a second call, with one
    read-back a call; median CUDA-event and device times, host
    microseconds a call, the twin's time, the bound by bytes and two
    library computations (``conv1d``, ``index_add_``; the faster is
    ``library_ms``); the tiles a row-range skip could spare are printed;
4i. (a) NCCL at world size 1 in this process: the step at 1 x 1 on two
    shards, with every launch count set to 0 just before it (the K14
    entry launched; the sum row equal to the bottom channels' sum), its
    wall over three more calls (host clock, each ended by a sync), and
    ``Simulator(default_config(seed=1234, chunk_size=100),
    device='cuda:0', mesh=make_mesh(1, 1))`` on the 512-event workload
    (after a 16-event warm-up), records and truth bitwise those of phase
    4's run; (b) gloo, 2
    processes on cuda:0 (started during (a), they wait for their turn):
    the same Simulator run (a 16-event warm-up, then timed with the
    counts at 0), every rank bitwise equal to phase 4's run and every
    default-path entry launched across the ranks; the step at 2 x 1 and
    1 x 2, blocks, sum rows and totals equal to 1 x 1's; then 4
    processes for the step at 2 x 2.  Printed: wall time and events/s of
    each run and the bytes broadcast; ranks that share one card are no
    speedup.  A child that exits non-zero or outlives its limit fails the
    phase.

4r. the optical configurations (OPTICAL_CONFIGS; illustrative inputs,
    not a calibration), each on 512 events 10 ms apart read by the port's
    ``read_optical`` from an in-memory GEANT4 ``events`` tree
    (``resources.synthetic.synthetic_g4_file`` behind a stub ``uproot``;
    one event in 50 has hits past 1 us, which ``optical_adjustment``
    splits off as an instruction of its own): ``optical_nveto``
    (XENONnT_neutron_veto, 120 PMTs, Poisson hits of mean 3,000 on
    channels 2000-2119 at 2.0-4.1 eV thinned by a flat 30 % QE over
    300-600 nm to ~0.45 M photons, times exponential with tau 200 ns, PMT
    afterpulses on) and ``optical_tpc`` (XENONnT, Poisson 300 hits over
    the 494 channels, tau 25 ns, per-PMT truth on), through
    ``ChunkRawRecords(rawdata_generator=RawDataOptical)`` on the card,
    warm-up then timed with the launch counts reset just before: one
    truth row per instruction whose ``n_photon`` is the photons it keeps,
    the strax invariants with channels below the detector's count, the
    PMT response (K8), the digitizer (K1+K2, K3, K4) and K11 (nVeto) or
    K16 (XENONnT) launched; events/s and the wall time;
5r. the first simulation batch's optical response on the card and, from
    the same draws, through the twins on the CPU: photons bitwise, truth
    exact or within rtol 1e-12;
4t. the legacy pulse generator ``RawData.__call__`` over one super-batch
    of the default configuration (60 bench events): its pulses, cut back
    into records, are exactly the records of the same run;
4v. what wfsim_tpu runs and the port once refused: the default
    configuration's 512 events with one instruction of each type 0, 3, 5
    and 7 at the time and place of every S1 (2,048 more instructions,
    which join no batch; the super-batch cuts of the known ones do not
    move, tests/test_torch_surface_gaps.py), warm-up then timed with the
    launch counts reset: no truth row of those types, and the default
    run's records, launches and DEFAULT_DIGEST; then the realistic
    configuration with ``noise_file``, ``photon_ap_cdfs``,
    ``photon_area_distribution`` and ``ele_ap_pdfs`` naming files that
    resolve nowhere (an empty ``url_base`` directory, the fetch off): the
    synthetic assets, so the realistic run's records and launches and the
    digest of phase 4b's arrays.

Last, the stream (4s): the default configuration on 10,000 bench events
(20,000 instructions) with ``pipeline_depth`` = ceil(instructions / 1024),
super-batches of 1,000 instructions, and 1 s chunks; ``Simulator.run`` is
iterated and each chunk dropped.  Printed: super-batches and digitize
rounds, the time of the first chunk and the wall time, events/s, the peak
device memory (``torch.cuda.max_memory_allocated``, reset before the run;
also less what earlier phases still hold) and the host RSS high-water
(``VmRSS`` of /proc/self/status sampled per chunk, each sample after
``malloc_trim`` returns the heap's free pages).  The same run at 2,000
events, with the same super-batch size, goes first.  The phase fails
unless the long run's first chunk comes out before its last super-batch
is simulated, its device peak is at most 1.10 times the short run's, and
its RSS growth at most 1.25 times the short run's.

Each kernel row is timed three ways: ``ms``, the median CUDA-event time
around one wrapper call on an idle card (the wrapper's host work plus the
kernels); ``device_ms``, the median over the calls of the device time of
the kernels one call launches (CUPTI records of ``torch.profiler``, null
where the profiler records none); and, for the channel draw and the map
lookup, ``host_us``, host microseconds a call over 2,000 calls with one
sync at the end.  The sync check runs a wrapper under
``torch.cuda.set_sync_debug_mode('error')``.  Every row carries its
bound: the least time the card could take for the same work, the larger
of the bytes its wrapper must move (each input read once, each output
written once, counted from this run's tensors) over 3.35 TB/s and its
arithmetic (counted from the code on this run's sizes) over 67 TFLOP/s
float32 plus 34 TFLOP/s float64 (H100 SXM data sheet, non-tensor rates);
and, where PyTorch computes the same function around one library call,
that computation's time (``library_ms``: the channel draw from the
pattern through ``torch.searchsorted`` on targets padded per row, the map
lookup from the points through ``grid_sample``, the per-PMT truth from the
photons around one ``index_add_``, the superposition the fastest of a
gain histogram through ``conv1d`` and its taps through ``index_add_``, the
channel block of the step the same around its int32 epilogue, the
garfield times around one gather ``table[row_of_photon, cols]``).  The phase-2
line times ``stream_of``, which every wrapper calls.

Every configuration's 512-event run must give EXPECTED_RECORDS, K17
once a digitize batch, the channel draw, the map lookup, the ZLE,
record-pack and record-row
entries, the luminescence tables, the PMT-afterpulse and photon-summary
entries, the diffused pattern, the S2 electron and photon times and the
gas-gap times their EXPECTED_LAUNCHES (field_maps: the map lookup, the
luminescence tables with gas gaps and the diffused pattern; the optical
runs: the PMT response, the ZLE, record-pack and record-row entries and
K11 or K16; the record rows on every run), and the default run
DEFAULT_DIGEST: a change that keeps every kernel's output keeps them.

The second-to-last line is the JSON kernel table, the last line
``{"ok": true, "device": {...}}``.
"""
import datetime
import hashlib
import json
import multiprocessing
import pickle
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

#: the physics kernel entries (K5, K6, K8, K9), on both main paths
PHYSICS_KERNELS = ('wfsim_channel_draw', 'wfsim_lumi_tables',
                   'wfsim_s1_photon_times', 'wfsim_s2_electron_times',
                   'wfsim_s2_photon_times', 'wfsim_pmt_photon_pass',
                   'wfsim_pmt_row_truth')
#: the ZLE (K3) and record-pack (K4) entries: each once a digitize batch
ZLE_PACK_KERNELS = ('wfsim_zle_intervals', 'wfsim_pack_record_counts',
                    'wfsim_pack_records')
#: the round ordering and the record rows (K4r): once a digitize round
#: with records
ROUND_KERNELS = ('wfsim_round_order', 'wfsim_record_rows')
#: the arena gather and channel extents (K17): once a digitize batch
WINDOW_KERNELS = ('wfsim_window_rows',)
#: the first designs' device ms on phase 3w's and 3u's rows (PERF.md §6:
#: K17 as first written, K4r as first written, and the stable torch.sort
#: of packed keys that ordered a round before round_order.cu), printed
#: beside this run's
PARENT_DEVICE_MS = dict(window_rows=0.0310, window_rows_skewed=0.0828,
                        window_rows_default=0.0333, record_rows=0.0927,
                        round_order=0.165)
#: the kernel entries each main path must launch
DEFAULT_PATH_KERNELS = ('wfsim_superpose_adc', *WINDOW_KERNELS,
                        *ZLE_PACK_KERNELS, *ROUND_KERNELS,
                        'wfsim_grid_lookup') + PHYSICS_KERNELS
#: the PMT-afterpulse generator's entries (K11): each once a call
AP_KERNELS = ('wfsim_pmt_ap_select', 'wfsim_pmt_ap_rows', 'wfsim_pmt_ap_emit')
#: the photon summaries' entries (K11 summaries): each once a call
SUMMARY_KERNELS = ('wfsim_ap_valid_tiles', 'wfsim_ap_photon_summaries')
REALISTIC_PATH_KERNELS = DEFAULT_PATH_KERNELS + AP_KERNELS + SUMMARY_KERNELS
#: the detector_physics path: the gas-gap sampler replaces the simple
#: luminescence tables
DETECTOR_PATH_KERNELS = tuple(
    k for k in DEFAULT_PATH_KERNELS if k != 'wfsim_lumi_tables') + (
    'wfsim_pattern_diffuse', 'wfsim_lumi_gasgap_times', 'wfsim_nest_delays')

#: the he_full_grid path: the full-grid entry replaces superpose_adc
FULL_GRID_PATH_KERNELS = tuple(
    k for k in REALISTIC_PATH_KERNELS if k != 'wfsim_superpose_adc') + (
    'wfsim_superpose_adc_full',)

#: the timing_models path: the custom delays and the garfield times take
#: the place of the simple luminescence tables
TIMING_PATH_KERNELS = tuple(
    k for k in DEFAULT_PATH_KERNELS if k != 'wfsim_lumi_tables') + (
    'wfsim_s1_custom_delays', 'wfsim_lumi_garfield_times')

#: the field_maps path: the default one plus the diffused pattern
#: (transverse diffusion from the maps); the luminescence tables take a
#: gas gap a row
FIELD_MAPS_PATH_KERNELS = DEFAULT_PATH_KERNELS + ('wfsim_pattern_diffuse',)

#: the per_pmt_truth path: the realistic one plus the per-PMT entry (K16)
PER_PMT_PATH_KERNELS = REALISTIC_PATH_KERNELS + (
    'wfsim_pmt_row_truth_per_pmt',)
#: the xenon1t_full_grid path: the full-grid entry (in its mode without HE
#: rows) in place of superpose_adc, and per-PMT truth
X1T_PATH_KERNELS = FULL_GRID_PATH_KERNELS + ('wfsim_pmt_row_truth_per_pmt',)
#: the optical path (photons from a GEANT4 list): the PMT response (K8)
#: and the digitizer (K1+K2, K3, K4); the nVeto run adds the PMT
#: afterpulses (K11), the XENONnT run the per-PMT truth (K16)
OPTICAL_PATH_KERNELS = ('wfsim_pmt_photon_pass', 'wfsim_pmt_row_truth',
                        'wfsim_superpose_adc', *WINDOW_KERNELS,
                        *ZLE_PACK_KERNELS, *ROUND_KERNELS)
OPTICAL_CONFIGS = dict(
    optical_nveto=dict(detector='XENONnT_neutron_veto', first_channel=2000,
                       n_channels=120, mean_hits=3000, tau_ns=200.0,
                       overrides=dict(enable_pmt_afterpulses=True),
                       kernels=OPTICAL_PATH_KERNELS + AP_KERNELS),
    optical_tpc=dict(detector='XENONnT', first_channel=0, n_channels=494,
                     mean_hits=300, tau_ns=25.0,
                     overrides=dict(per_pmt_truth=True),
                     kernels=OPTICAL_PATH_KERNELS + (
                         'wfsim_pmt_row_truth_per_pmt',)))
#: the optical runs' events: 512, one every 10 ms
OPTICAL_EVENTS, OPTICAL_SPACING_NS = 512, 10_000_000

K5_REPLACES = ('wfsim_tpu/ops/randsample.py:120; '
               'wfsim_tpu/ops/randsample.py:99')

#: H100 SXM peaks (NVIDIA data sheet; at the 700 W limit): HBM3 bytes/s,
#: float32 and float64 operations/s outside the tensor cores
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
PEAK_F64 = 34e12


def nbytes(*xs):
    """Bytes of the tensors in ``xs`` (nested dicts, tuples and GridMaps
    walked; None and non-tensors count 0)."""
    import torch
    total = 0
    for x in xs:
        if isinstance(x, torch.Tensor):
            total += x.numel() * x.element_size()
        elif isinstance(x, dict):
            total += nbytes(*x.values())
        elif isinstance(x, (tuple, list)):
            total += nbytes(*x)
        elif hasattr(x, 'values') and hasattr(x, 'lows'):
            total += nbytes(x.values, x.lows, x.highs)
    return total


def bound(n_bytes, ops32=0, ops64=0):
    """(bound_ms, bound_by): the larger of the bytes over the memory rate
    and the operations over the peak rates."""
    t_bytes = n_bytes / PEAK_BYTES
    t_ops = ops32 / PEAK_F32 + ops64 / PEAK_F64
    return (max(t_bytes, t_ops) * 1e3,
            'bytes' if t_bytes >= t_ops else 'operations')


def sh(cmd):
    return subprocess.run(cmd, capture_output=True, text=True,
                          check=True).stdout.strip()


def cuda_ms(fn, reps=20, warmup=3):
    """Median device time of ``fn`` in ms (CUDA events around each call)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


#: bytes written before each call of a cold session (device_ms): 2.5 times
#: the H100's 50 MB L2, so no line of the call's inputs is left in it
L2_FLUSH_BYTES = 128 << 20


def device_ms(fn, reps=20, warmup=3, names=None, cold=False):
    """Median device time of one call of ``fn`` in ms and the device time
    per call of each kernel it launches, by name: the CUPTI records of a
    ``torch.profiler`` session over ``reps`` calls, each followed by a
    sync, cut into calls (see cut_calls; with ``names``, a tuple of
    substrings, only the records whose names hold one of them, see
    named_calls).  ``cold`` (only with ``names``, which leave the flush's
    records out) writes L2_FLUSH_BYTES before each call, so the call reads
    its inputs from HBM and its writes evict dirty lines.  (None, {})
    where they do not cut cleanly: no estimate is made."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    if cold and names is None:
        raise ValueError('a cold session needs names (the flush is left out)')
    flush = (torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.int32,
                         device='cuda') if cold else None)
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        if names is not None:
            # where CUPTI drops a session's first records, let them be
            # fills, which named_calls leaves out
            x = torch.empty(8, device='cuda')
            for _ in range(8):
                x.fill_(0.0)
            torch.cuda.synchronize()
        for _ in range(reps):
            if flush is not None:
                flush.fill_(1)
            fn()
            torch.cuda.synchronize()
    recs = [(e.name, e.time_range.elapsed_us()) for e in sorted(
        (e for e in prof.events() if e.device_type == DeviceType.CUDA
         and 'Activity Buffer' not in e.name),
        key=lambda e: e.time_range.start)]
    calls = (cut_calls(recs, reps) if names is None else
             named_calls(recs, reps, names))
    if not calls:
        print(f'[profiler] {len(recs)} device records in {reps} calls: no '
              f'per-call device time')
        return None, {}
    by_name = {}
    for call in calls:
        for name, us in call:
            by_name[name] = by_name.get(name, 0.0) + us / len(calls) / 1e3
    return (statistics.median(sum(us for _n, us in c) for c in calls) / 1e3,
            by_name)


def cut_calls(recs, reps):
    """The device records ``(name, us)`` of a session, in start order, cut
    into the calls that launched them: k = ceil(records / reps) records a
    call (every call launches the same kernels in the same order).  The
    profiler misses the first record or few of a session on this card, so
    the complete calls are cut from the end (from the start if that fits
    instead: the names of every call must be the same); at least half of
    the calls must be complete.  [] otherwise."""
    if not recs:
        return []
    k = -(-len(recs) // reps)
    m = len(recs) // k
    for run in (recs[len(recs) - m * k:], recs[:m * k]):
        calls = [run[i * k:(i + 1) * k] for i in range(m)]
        names = [[n for n, _us in c] for c in calls]
        if 2 * m >= reps and all(x == names[0] for x in names):
            return calls
    return []


def named_calls(recs, reps, names):
    """The device records ``(name, us)`` of a session whose names hold one
    of ``names`` (what the measured entry launches), cut into ``reps``
    calls: each such name must appear a whole multiple of ``reps`` times
    and every call must hold the same names in the same order.  [] where
    the profiler dropped or added one of them."""
    recs = [r for r in recs if any(x in r[0] for x in names)]
    counts = {}
    for n, _us in recs:
        counts[n] = counts.get(n, 0) + 1
    if not recs or any(c % reps for c in counts.values()):
        return []
    k = len(recs) // reps
    calls = [recs[i * k:(i + 1) * k] for i in range(reps)]
    names_0 = [n for n, _us in calls[0]]
    if any([n for n, _us in c] != names_0 for c in calls):
        return []
    return calls


def below_bound(name, dev_ms, b_ms):
    """Raise where a measured device time lies below the row's bound: the
    profiler's records are then wrong, and the number is not reported."""
    if dev_ms is not None and dev_ms < b_ms:
        raise AssertionError(f'{name}: device time {dev_ms:.6f} ms below '
                             f'its bound {b_ms:.6f} ms')


def bounded_device_ms(name, fn, names, b_ms, tries=3):
    """``device_ms(fn, names=names)``, the session taken again (up to
    ``tries`` sessions) where it gives no time or one below the bound
    ``b_ms``: in this long process CUPTI sometimes drops records of a
    session (PERF.md §7).  The bound is HBM's; a call whose bytes fit the
    50 MB L2 can beat it on the inputs its warm-up left there, so after a
    time below the bound the sessions are cold (device_ms).  Raises
    (below_bound) where every session that gave a time gave one below the
    bound; (None, {}) where none gave one."""
    low = None
    cold = False
    for _ in range(tries):
        dev_ms, by_name = device_ms(fn, names=names, cold=cold)
        if dev_ms is not None and dev_ms >= b_ms:
            if cold:
                print(f'[profiler] {name}: device time {dev_ms:.6f} ms with '
                      f'the L2 flushed before each call')
            return dev_ms, by_name
        if dev_ms is not None:
            low = dev_ms
            print(f'[profiler] {name}: device time {dev_ms:.6f} ms below '
                  f'its bound {b_ms:.6f} ms: the session is taken again '
                  f'with the L2 flushed before each call')
            cold = True
    below_bound(name, low, b_ms)
    return None, {}


def timing(kernel, twin, n_bytes, ops32, ops64=0, err=0, reps=20,
           plain_reps=20):
    """The measurements of a kernel row timed outside ``make_check``:
    ``dict(err, ms, device_ms, plain_ms, bytes, ops32, ops64, library_ms,
    host_us)`` (no library call, no host timing)."""
    return dict(err=err, ms=cuda_ms(kernel, reps=reps),
                device_ms=device_ms(kernel, reps=reps)[0],
                plain_ms=cuda_ms(twin, reps=plain_reps), bytes=n_bytes,
                ops32=ops32, ops64=ops64, library_ms=None, host_us=None)


def fmt_ms(x):
    return 'not measured' if x is None else f'{x:.4f} ms'


def host_us(fn, calls=2000):
    """Host microseconds per call of ``fn``: ``perf_counter`` over
    ``calls`` calls with one sync at the end, results discarded (where the
    device takes longer per call than the host, this is the device's
    rate)."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / calls * 1e6


def busy_union(intervals):
    """The length of the union of ``(start, end)`` intervals."""
    total = 0.0
    lo = hi = None
    for a, b in sorted(intervals):
        if hi is None or a > hi:
            if hi is not None:
                total += hi - lo
            lo, hi = a, b
        else:
            hi = max(hi, b)
    return total + (0.0 if hi is None else hi - lo)


def device_busy(fn, walls=3):
    """The device's busy share of one call of ``fn`` (a warm run): the
    union of the intervals of the device records (kernels, copies, sets)
    of a ``torch.profiler`` session around one call, over the median host
    wall time of ``walls`` calls without the profiler; also over the
    profiled call's own wall.  Returns dict(share, share_profiled, busy_s,
    copy_s, wall_s, wall_profiled_s, records)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    times = []
    for _ in range(walls):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    wall = statistics.median(times)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_p = time.perf_counter() - t0
    evs = [e for e in prof.events() if e.device_type == DeviceType.CUDA
           and 'Activity Buffer' not in e.name]
    busy = busy_union((e.time_range.start, e.time_range.end)
                      for e in evs) / 1e6
    copy = busy_union((e.time_range.start, e.time_range.end)
                      for e in evs if 'Memcpy' in e.name) / 1e6
    return dict(share=busy / wall, share_profiled=busy / wall_p,
                busy_s=busy, copy_s=copy, wall_s=wall,
                wall_profiled_s=wall_p, records=len(evs))


def s2_like_arena(rng, n_win, n_ch, n_samples, n_mean=4600, sigma=1500):
    """Per window ~``n_mean`` photons (4.6k: one bench S2), uniform over
    channels, times spread like a drifted S2 (``sigma`` ns) around the
    window centre, SPE-like gains."""
    t, ch, g, pieces = [], [], [], np.zeros((n_win, 1, 3), np.int64)
    lo = 0
    for w in range(n_win):
        n = int(rng.poisson(n_mean))
        tt = rng.normal(n_samples * 5, sigma, n) + rng.exponential(140, n)
        t.append(np.clip(tt, 600, n_samples * 10 - 600).astype(np.int32))
        ch.append(rng.integers(0, n_ch, n).astype(np.int32))
        gain = 2e6 * np.clip(rng.normal(1.0, 0.4, n), 0.05, None)
        gain *= np.where(rng.random(n) < 0.219, 2.0, 1.0)
        g.append(gain.astype(np.float32))
        pieces[w, 0] = (lo, n, 0)
        lo += n
    return np.concatenate(t), np.concatenate(ch), np.concatenate(g), pieces


def strax_valid(rr, n_ch):
    return bool(len(rr) and np.all(np.diff(rr['time']) >= 0)
                and rr['length'].max() <= 110 and rr['channel'].max() < n_ch
                and rr['channel'].min() >= 0 and rr['data'].min() >= 0
                and np.all(rr['pulse_length'] >= rr['length']))


def s2_like_photons(rng, n, n_ch, n_rows, dev):
    """A primary photon batch shaped like the bench S2 batch: ``n``
    photons over ``n_rows`` truth rows, uniform channels, 21.9 % double-PE,
    a few without a channel."""
    import torch
    ch = rng.integers(0, n_ch, n).astype(np.int32)
    ch[rng.random(n) < 0.01] = -1
    ph = dict(t=rng.integers(0, 3_000_000, n).astype(np.int32), ch=ch,
              is_dpe=rng.random(n) < 0.219, valid=ch >= 0,
              truth_row=np.sort(rng.integers(0, n_rows, n)).astype(np.int64))
    return {k: torch.as_tensor(v, device=dev) for k, v in ph.items()}


def max_diff(a, b):
    """max |a - b| over matching outputs (floats compared by their bits, so
    -0.0 and +0.0 differ; a difference is reported as at least the
    smallest positive value); raises on a shape mismatch."""
    import torch
    if a.shape != b.shape or a.dtype != b.dtype:
        raise AssertionError(f'{tuple(a.shape)} {a.dtype} vs '
                             f'{tuple(b.shape)} {b.dtype}')
    if not a.numel():
        return 0.0
    if a.dtype == torch.float32:
        if not torch.equal(a.view(torch.int32), b.view(torch.int32)):
            return max(float((a - b).abs().max()), 1e-45)
        return 0.0
    if a.dtype == torch.float64:
        if not torch.equal(a.view(torch.int64), b.view(torch.int64)):
            return max(float((a - b).abs().max()), 1e-300)
        return 0.0
    return float((a.to(torch.int64) - b.to(torch.int64)).abs().max())


def physics_phases(sim):
    """The simulate_* Timers phases (seconds) of a Simulator's last run."""
    return {k: v for k, v in sim.sim.rawdata.diag.summary().items()
            if k.startswith('simulate_')}


def to_device(x, dev):
    """A (nested) dict of tensors, or a tensor, on ``dev`` (anything else,
    None or a host count such as the S2 draws' ``diff_split``, kept)."""
    import torch
    if isinstance(x, dict):
        return {k: to_device(v, dev) for k, v in x.items()}
    return x.to(dev) if isinstance(x, torch.Tensor) else x


def compare(a, b, what, rtol_keys=()):
    """Largest difference between two dicts (or tuples) of tensors: bitwise
    (``max_diff``) for every entry, relative for ``rtol_keys``, where it
    must stay within 1e-12.  Raises on a mismatch; returns the largest
    absolute difference."""
    import torch
    if not isinstance(a, dict):
        a, b = dict(enumerate(a)), dict(enumerate(b))
    if a.keys() != b.keys():
        raise AssertionError(f'{what}: keys {sorted(a)} vs {sorted(b)}')
    worst = 0.0
    for k in a:
        x, y = a[k].cpu(), b[k].cpu()
        if k in rtol_keys:
            if x.shape != y.shape or x.dtype != y.dtype:
                raise AssertionError(f'{what} {k}: {x.shape} {x.dtype} vs '
                                     f'{y.shape} {y.dtype}')
            d = (x - y).abs()
            rel = float((d / torch.clamp_min(y.abs(), 1e-300)).max()) \
                if x.numel() else 0.0
            if rel > 1e-12:
                raise AssertionError(f'{what} {k}: relative difference {rel}')
            worst = max(worst, float(d.max()) if x.numel() else 0.0)
            continue
        d = max_diff(x, y)
        if d:
            raise AssertionError(f'{what} {k}: max|diff| {d}')
    return worst


#: truth sums compared with rtol 1e-12 (float64 sums of float32 areas, and
#: the moments derived from the float64 time sums); the rest are exact
FLOAT_TRUTH = ('raw_area', 'raw_area_trigger', 'raw_area_bottom',
               'raw_area_trigger_bottom', 'photon_t_mean_offset',
               'photon_t_sigma', 'electron_t_mean_offset', 'electron_t_sigma',
               't_mean_offset', 't_sigma')


def physics_batches(cfg, inst, dev, seed):
    """Every S1 and every S2 instruction of ``inst`` as one batch each (512
    instructions, ~1.57 M S2 photons on the bench workload; the simulator
    cuts its S2 batches at 1.5 s of span, so this one is a little larger
    than its largest), with their draws made on the card from one
    generator: ``{kind: (inst dict, n_rows, draws)}``."""
    import torch
    from wfsim_tpu_torch.models.s1 import s1_draws
    from wfsim_tpu_torch.models.s2 import s2_draws
    from wfsim_tpu_torch.pipeline.rawdata import RawData
    rd = RawData(cfg, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    out = {}
    for kind, typ, draw in (('s1', 1, s1_draws), ('s2', 2, s2_draws)):
        x, _base, _rows, n_rows = rd.batch_inputs(
            inst, np.flatnonzero(inst['type'] == typ), kind)
        out[kind] = (x, n_rows, draw(rd.params, rd.const, x, gen))
    return rd.params, rd.const, out


def make_check(res, tag, smi):
    """A function that holds a kernel against its twin, times both and
    stores ``res[name] = dict(err, ms, device_ms, plain_ms, bytes, ops32,
    ops64, library_ms, host_us)``; ``inputs`` are the tensors the kernel
    reads (its outputs are added to the byte count), ``library`` one
    PyTorch call computing the same function, timed beside it; ``host``
    adds the wrapper's host microseconds per call (see host_us)."""
    def check(name, kernel, twin, inputs, ops32, ops64=0, rtol_keys=(),
              reps=20, library=None, host=False):
        out = kernel()
        err = compare(out, twin(), name, rtol_keys)
        dev_ms, by_name = device_ms(kernel, reps=reps)
        res[name] = dict(err=err, ms=cuda_ms(kernel, reps=reps),
                         device_ms=dev_ms,
                         plain_ms=cuda_ms(twin, reps=reps),
                         bytes=nbytes(inputs, out), ops32=ops32, ops64=ops64,
                         library_ms=(None if library is None
                                     else cuda_ms(library, reps=reps)),
                         host_us=host_us(kernel) if host else None)
        r = res[name]
        lib = ('' if library is None
               else f', library call {r["library_ms"]:.4f} ms')
        dev = ('not measured' if dev_ms is None else f'{dev_ms:.4f} ms '
               + str({k: round(v, 6) for k, v in by_name.items()}))
        hst = '' if not host else f', host {r["host_us"]:.2f} us a call'
        print(f'[{tag}] {name}: max|diff| {err}, {r["ms"]:.4f} ms, device '
              f'{dev}, plain twin {r["plain_ms"]:.4f} ms{lib}{hst}, bound '
              f'{bound(r["bytes"], ops32, ops64)[0]:.6f} ms ({smi})')
    return check


def searchsorted_library(pattern, ph_edges, u):
    """The channel draw in PyTorch around one library search: the float64
    CDF (``cumsum_f64``), the row totals, the targets ``u x total``
    scattered into rows padded to the longest, ``torch.searchsorted``, the
    clamp to C-1, -1 for rows without mass, the photons gathered back.
    Only the padded layout (each photon's row and position) is computed
    outside the returned call."""
    import torch
    from wfsim_tpu_torch.ops.randsample import cumsum_f64
    n_inst, C = pattern.shape
    counts = (ph_edges[1:] - ph_edges[:-1]).cpu().numpy()
    width = max(int(counts.max()), 1)
    pos = torch.as_tensor(np.arange(int(counts.sum())) - np.repeat(
        ph_edges[:-1].cpu().numpy(), counts), device=u.device)
    rows = torch.as_tensor(np.repeat(np.arange(len(counts)), counts),
                           device=u.device)

    def call():
        cdf = cumsum_f64(pattern, 1)
        total = cdf[:, -1][rows]
        targets = torch.zeros((n_inst, width), device=u.device)
        targets[rows, pos] = u * total
        idx = torch.searchsorted(cdf, targets, right=True)[rows, pos]
        return torch.where(total > 0, torch.clamp_max(idx, C - 1),
                           -1).to(torch.int32)
    return call


def sync_free(name, fn):
    """Run ``fn`` once under ``torch.cuda.set_sync_debug_mode('error')``,
    which raises where a torch call would sync the host with the card."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode('error')
    try:
        fn()
    finally:
        torch.cuda.set_sync_debug_mode('default')
    torch.cuda.synchronize()
    print(f'[sync] {name}: no host sync under '
          f'set_sync_debug_mode(\'error\')')


def skewed_draw_inputs(pattern, ph_edges, dev, seed):
    """A skewed channel-draw batch from the bench S2 batch: its rows and
    photon counts, except one row of 10^6 photons, three rows without
    photons (the last among them) and two rows without mass; fresh
    uniforms with 0 and 1 - 2^-24 among them."""
    import torch
    counts = (ph_edges[1:] - ph_edges[:-1]).cpu().numpy().copy()
    counts[100] = 1_000_000
    counts[[3, 200, len(counts) - 1]] = 0
    pat = pattern.clone()
    pat[[7, 300]] = 0.0
    edges = torch.as_tensor(np.concatenate([[0], np.cumsum(counts)]),
                            device=dev)
    u = np.random.default_rng(seed).random(int(counts.sum()),
                                           dtype=np.float32)
    u[::9973] = 0.0
    u[5::9973] = np.float32(1 - 2 ** -24)
    return pat, edges, torch.as_tensor(u, device=dev)


def check_k5(check, pattern, ph_edges, u, dev):
    """The channel draw (K5) against its twin on the bench S2 batch and on
    its skewed copy (skewed_draw_inputs), with the library call and the
    wrapper's host time; then once under the sync check (see
    sync_free)."""
    from wfsim_tpu_torch.ops.randsample import channel_draw, channel_draw_ref
    n_inst, C = pattern.shape
    skewed = skewed_draw_inputs(pattern, ph_edges, dev, 20261016)
    for name, args in (('channel_draw', (pattern, ph_edges, u)),
                       ('channel_draw_skewed', skewed)):
        n = int(args[2].shape[0])
        check(name, lambda a=args: (channel_draw(*a),),
              lambda a=args: (channel_draw_ref(*a),), args,
              ops32=n * (int(np.log2(C)) + 2), ops64=n_inst * C,
              library=searchsorted_library(*args), host=True)
        counts = args[1][1:] - args[1][:-1]
        print(f'[kernels-p] {name}: {n} photons in {n_inst} rows (largest '
              f'{int(counts.max())}, empty {int((counts == 0).sum())}, '
              f'without mass {int((args[0].sum(1) == 0).sum())})')
    sync_free('channel_draw', lambda: channel_draw(*skewed))


def phase_3c(params, const, batches, dev, smi):
    """Each physics kernel against its twin on the card (see the module
    docstring); returns {name: measurements} (see make_check)."""
    import torch
    from wfsim_tpu_torch.models import pmt
    from wfsim_tpu_torch.models.s1 import (masked_pattern, row_edges_of,
                                           s1_photon_times,
                                           s1_photon_times_ref)
    from wfsim_tpu_torch.models.s2 import (
        get_s2_drift_time_params, luminescence_tables,
        luminescence_tables_ref, s2_edges, s2_electron_times,
        s2_electron_times_ref, s2_photon_times, s2_photon_times_ref)
    from wfsim_tpu_torch.ops.randsample import channel_draw
    from wfsim_tpu_torch.ops.segment import edges_from_counts
    x1, _n1, d1 = batches['s1']
    x2, n_rows, d2 = batches['s2']
    n_inst = int(x2['x'].shape[0])
    e_edges, e_ph_edges, ph_edges = s2_edges(d2)
    n_ph = int(ph_edges[-1])
    n_e = int(e_edges[-1])
    n_s1 = int(d1['n_hits'].sum())
    C = int(params.gains.shape[0])
    res = {}
    check = make_check(res, 'kernels-p', smi)

    pattern = masked_pattern(params, params.s2_pattern,
                             torch.stack([x2['x'], x2['y']], dim=1))
    print(f'[kernels-p] S2 batch: {n_inst} instructions, '
          f'{n_e} electrons, {n_ph} photons; S1 batch: '
          f'{int(x1["x"].shape[0])} instructions, {n_s1} photons')
    check_k5(check, pattern, ph_edges, d2['u_ch'], dev)

    inv = luminescence_tables(const, n_inst, dev)
    compare((inv,), (luminescence_tables_ref(const, n_inst, 'cpu'),),
            'lumi_tables against the CPU twin')
    compare((inv,), (luminescence_tables_ref(const, n_inst, dev),),
            'lumi_tables')
    print(f'[kernels-p] lumi_tables: {n_inst} instructions, bitwise the '
          f'twin on the card and on the CPU (3m times it)')

    s1_args = (x1['time'], edges_from_counts(d1['n_hits']), x1['truth_row'],
               d1['exp'], d1['normal'])
    s1_kw = dict(decay_time=const.s1_decay_time,
                 decay_spread=const.s1_decay_spread)
    check('s1_photon_times', lambda: s1_photon_times(*s1_args, **s1_kw),
          lambda: s1_photon_times_ref(*s1_args, **s1_kw), s1_args,
          ops32=n_s1 * 4)

    mean, spread = get_s2_drift_time_params(
        params, const, x2['z'], torch.stack([x2['x'], x2['y']], dim=1))
    e_args = (x2['time'], e_edges, mean, spread, d2['e_exp'], d2['e_normal'],
              x2['truth_row'])
    e_kw = dict(trapping=const.electron_trapping_time)
    check('s2_electron_times', lambda: s2_electron_times(*e_args, **e_kw),
          lambda: s2_electron_times_ref(*e_args, **e_kw), e_args,
          ops32=n_e * 5)
    e_t, e_row = s2_electron_times(*e_args, **e_kw)

    p_args = (inv, e_edges, e_ph_edges, e_t, x2['truth_row'], d2['u_lum'],
              d2['u_st'], d2['exp_st'], d2['t_spread'])
    p_kw = dict(singlet_fraction=const.singlet_fraction_gas,
                t_singlet=const.singlet_lifetime_gas,
                t_triplet=const.triplet_lifetime_gas,
                time_spread=const.s2_time_spread)
    check('s2_photon_times', lambda: s2_photon_times(*p_args, **p_kw),
          lambda: s2_photon_times_ref(*p_args, **p_kw), p_args,
          ops32=n_ph * 12)
    t, truth_row = s2_photon_times(*p_args, **p_kw)

    ch = channel_draw(pattern, ph_edges, d2['u_ch'])
    pp_args = (params, const, t, ch, ch >= 0, truth_row, d2['pmt'])
    check('pmt_photon_pass', lambda: pmt._photon_pass(*pp_args),
          lambda: pmt.photon_pass_ref(*pp_args),
          (t, ch, truth_row, d2['pmt'], params.chan_pack,
           params.uniform_to_pe), ops32=n_ph * 16, host=True)
    ph = pmt._photon_pass(*pp_args)
    row_edges = row_edges_of(x2['truth_row'], ph_edges, n_rows)

    def row_ref():
        out = pmt.pulse_truth_ref(params, const, ph, row_edges)
        out.update(pmt.photon_time_stats_ref(ph['t'], ph['valid'], truth_row,
                                             n_rows, row_edges))
        return out
    check('pmt_row_truth',
          lambda: pmt._row_truth(params, const, ph['t'], ph['valid'],
                                 row_edges, ph=ph), row_ref,
          (ph, row_edges, params.chan_pack, params.current_max),
          ops32=n_ph * 8, ops64=n_ph * 14, rtol_keys=FLOAT_TRUTH)
    e_row_edges = row_edges_of(x2['truth_row'], e_edges, n_rows)
    err = compare(pmt._row_truth(None, None, e_t, None, e_row_edges),
                  pmt.photon_time_stats_ref(e_t, None, e_row, n_rows,
                                            e_row_edges),
                  'pmt_row_truth (electron times)', FLOAT_TRUTH)
    res['pmt_row_truth']['err'] = max(err, res['pmt_row_truth']['err'])
    print(f'[kernels-p] pmt_row_truth on the electron times: '
          f'max|diff| {err}')
    return res


def grid_sample_library(gmap, points):
    """The multilinear lookup as ``torch.nn.functional.grid_sample``
    (align_corners=True, border padding): the returned call normalises the
    points to [-1, 1] and samples the map, laid out once beforehand as (1,
    C, [gz,] gy, gx) (a 1-d map as (1, C, 1, gx), its points at y = 0)."""
    import torch
    d = gmap.values.dim() - 1
    n, out_dim = points.shape[0], gmap.values.shape[-1]
    inp = gmap.values.permute(*range(d, -1, -1)).unsqueeze(0).contiguous()
    if d == 1:                     # a 1-d map as a 2-d one of height 1
        inp = inp.unsqueeze(2)

    def call():
        norm = (points - gmap.lows) / (gmap.highs - gmap.lows) * 2 - 1
        if d == 1:
            norm = torch.cat([norm, torch.zeros_like(norm)], dim=1)
        dd = max(d, 2)
        return torch.nn.functional.grid_sample(
            inp, norm.reshape((1,) * dd + (n, dd)), mode='bilinear',
            padding_mode='border', align_corners=True).reshape(out_dim, n)
    return call


def photon_width_map(n_pts, dev, seed):
    """A synthetic 50 x 50 x 100 float32 map with one output and ``n_pts``
    points (the optical splines' photon width) spread over it and 5 cm
    around it, with some at the lows and on the upper faces."""
    import torch
    from wfsim_tpu_torch.ops.interp import GridMap
    rng = np.random.default_rng(seed)
    lows = np.array([-70, -70, -150], np.float32)
    highs = np.array([70, 70, 0], np.float32)
    gmap = GridMap(*(torch.as_tensor(a, device=dev) for a in (
        rng.uniform(0.05, 0.3, (50, 50, 100, 1)).astype(np.float32), lows,
        highs)))
    pts = rng.uniform(lows - 5, highs + 5, (n_pts, 3)).astype(np.float32)
    pts[:1000] = lows
    pts[1000:2000, 2] = highs[2]
    pts[2000:3000] = highs
    return gmap, torch.as_tensor(pts, device=dev)


def check_k12a(check, params, xy2, dev):
    """The map lookup (K12a) against its twin: 1,024 points in the TPC on
    the 3-d FDC map and on the 30 x 30 x 494 pattern map, the S2 batch's
    instruction positions ``xy2`` on the pattern map, and the photon-width
    map (photon_width_map); each with the grid_sample call and the
    wrapper's host time; then once under the sync check (see
    sync_free)."""
    import torch
    from wfsim_tpu_torch.ops.interp import grid_lookup_ref
    rng = np.random.default_rng(20261016)
    n_pts = 1024
    r = np.sqrt(rng.uniform(0, 45 ** 2, n_pts))
    phi = rng.uniform(-np.pi, np.pi, n_pts)
    pts3 = torch.as_tensor(np.stack([r * np.cos(phi), r * np.sin(phi),
                                     rng.uniform(-90, -10, n_pts)], 1),
                           dtype=torch.float32, device=dev)
    pts2 = pts3[:, :2].contiguous()
    big_map, big_pts = photon_width_map(1_570_000, dev, 20261016)
    for name, gmap, pts in (('grid_lookup_3d', params.fdc_3d, pts3),
                            ('grid_lookup', params.s2_pattern, pts2),
                            ('grid_lookup_512', params.s2_pattern, xy2),
                            ('grid_lookup_photons', big_map, big_pts)):
        n, d = pts.shape
        out_dim = int(gmap.values.shape[-1])
        check(name, lambda m=gmap, p=pts: (m(p),),
              lambda m=gmap, p=pts: (grid_lookup_ref(m.values, m.lows,
                                                     m.highs, p),),
              (gmap, pts), ops32=n * (d * 6 + out_dim * 2 ** d * (d + 1)),
              library=grid_sample_library(gmap, pts), host=True)
        print(f'[kernels-d] {name}: map {tuple(gmap.values.shape)}, '
              f'{n} points')
    sync_free('grid_lookup', lambda: (params.s2_pattern(xy2),
                                      big_map(big_pts)))


def phase_3d(params, const, batches, dev, smi):
    """Each detector_physics kernel against its twin on the card (see the
    module docstring); returns {name: measurements} (see make_check)."""
    import torch
    from wfsim_tpu_torch.models import s2
    x1, _n1, d1 = batches['s1']
    x2, _n_rows, d2 = batches['s2']
    n_inst = int(x2['x'].shape[0])
    e_edges, _e_ph_edges, ph_edges = s2.s2_edges(d2)
    n_e, n_ph = int(e_edges[-1]), int(ph_edges[-1])
    n_s1 = int(d1['n_hits'].sum())
    res = {}
    check = make_check(res, 'kernels-d', smi)
    print(f'[kernels-d] S2 batch: {n_inst} instructions, {n_e} electrons, '
          f'{n_ph} photons; S1 batch: {int(x1["x"].shape[0])} '
          f'instructions, {n_s1} photons')

    check_k12a(check, params, torch.stack([x2['x'], x2['y']], dim=1), dev)

    _z, xy = s2.s2_positions(params, const, x2)
    gg_args = (params.gg_inv_cdf, *s2.gasgap_rows(params, xy), ph_edges,
               d2['u_lum'])
    check('lumi_gasgap_times', lambda: (s2.lumi_gasgap_times(
              *gg_args, t_max=params.gg_t_max),),
          lambda: (s2.lumi_gasgap_times_ref(*gg_args),), gg_args,
          ops32=n_ph * 16, ops64=n_ph * 2)

    return res


def phase_5c(cfg, params_d, const, batches, smi, tag='cross-p'):
    """The S1 and S2 batches through the kernels on the card and, from the
    same draws, through the twins on the CPU (see the module docstring)."""
    import torch
    from wfsim_tpu_torch.models.params import build_params
    from wfsim_tpu_torch.models.s1 import s1_photon_pass
    from wfsim_tpu_torch.models.s2 import s2_photon_pass
    from wfsim_tpu_torch.resources import load_config
    params_c = build_params(cfg, load_config(cfg), 'cpu')
    cpu = torch.device('cpu')
    for kind, fn in (('s1', s1_photon_pass), ('s2', s2_photon_pass)):
        x, n_rows, draws = batches[kind]
        t0 = time.perf_counter()
        ph_d, tr_d, req_d = fn(params_d, const, x, draws, n_truth_rows=n_rows)
        torch.cuda.synchronize()
        t_card = time.perf_counter() - t0
        t0 = time.perf_counter()
        ph_c, tr_c, req_c = fn(params_c, const, to_device(x, cpu),
                               to_device(draws, cpu), n_truth_rows=n_rows)
        t_cpu = time.perf_counter() - t0
        compare(ph_d, ph_c, f'{kind} photons card vs CPU')
        compare((req_d,), (req_c,), f'{kind} photon counts card vs CPU')
        err = compare(tr_d, tr_c, f'{kind} truth card vs CPU', FLOAT_TRUTH)
        print(f'[{tag}] {kind}: photons {int(ph_d["t"].shape[0])} rows '
              f'{n_rows}: photons bitwise equal, truth max|diff| {err} '
              f'(card {t_card:.3f} s, CPU twins {t_cpu:.3f} s; {smi})')


def phase_full_grid(sargs, skw, ph, B, T, K, inst, dev, smi):
    """Phases 3e, 4e and 5e (see the module docstring); returns the launch
    counts of the 4e run (phase 3j times the full-grid row)."""
    import torch
    from wfsim_tpu_torch.config import default_config, he_full_grid_overrides
    from wfsim_tpu_torch.models.params import build_params, build_constants
    from wfsim_tpu_torch.ops.waveform import (superpose_adc_full,
                                              superpose_adc_full_ref)
    from wfsim_tpu_torch.ops.zle import zle_all_channels, zle_all_channels_ref
    from wfsim_tpu_torch.pipeline.digitize import (
        full_grid_rows, gather_digitize, pack_records)
    from wfsim_tpu_torch.pipeline.rawdata import RawData
    from wfsim_tpu_torch.resources import load_config
    from wfsim_tpu_torch.resources.synthetic import write_production_files
    tmp = tempfile.mkdtemp(prefix='wfsim_smoke_he_')
    try:
        t0 = time.perf_counter()
        write_production_files(tmp, 1234)
        t_write = time.perf_counter() - t0
        cfg = default_config(seed=1234, chunk_size=100,
                             **he_full_grid_overrides(tmp))
        t0 = time.perf_counter()
        params = build_params(cfg, load_config(cfg), dev)
        t_load = time.perf_counter() - t0
        const = build_constants(cfg)
        C, R, n_top = (const.n_tpc_pmts, const.n_channels_total,
                       const.n_top_pmts)
        Cn, L = params.noise_bank.shape
        print(f'[full] one-off host costs: resource files written in '
              f'{t_write:.3f} s, read and moved to the card in {t_load:.3f} '
              f's; bank {Cn} x {L}, factor {const.high_energy_deamp_int}')

        # ---- 3e. the full-grid kernel against its twin -------------------
        nix = torch.as_tensor(L - T // 2 + np.arange(B) * 7,
                              dtype=torch.int32, device=dev)  # all wrap
        fkw = dict(skw, n_channels=C, n_channels_total=R, n_top=n_top,
                   he_start=const.he_channel_start,
                   sum_channel=const.sum_signal_channel,
                   deamp=const.high_energy_deamp_int,
                   noise_bank=params.noise_bank, noise_ix=nix)
        grid = superpose_adc_full(*sargs, **fkw)
        grid_ref = superpose_adc_full_ref(*sargs, **fkw)
        err = max_diff(grid, grid_ref)
        he = slice(const.he_channel_start, const.he_channel_start + n_top)
        print(f'[kernels-f] superpose_adc_full: {B} x {R} x {T}, noise_ix '
              f'{nix[0].item()}.. of L={L}, differing samples '
              f'{int((grid != grid_ref).sum())}, max|diff| {err}, HE rows '
              f'non-zero {int((grid[:, he] != 0).sum())}, sum row non-zero '
              f'{int((grid[:, const.sum_signal_channel] != 0).sum())}')
        if err or not grid[:, he].any():
            raise AssertionError('superpose_adc_full differs from its twin '
                                 'or leaves the HE rows empty')
        rows = [full_grid_rows(ph[k].reshape(B, C), const).reshape(-1)
                for k in ('ch_left', 'ch_right', 'has')]
        zthr = params.zle_thresholds[:R].repeat(B).contiguous()
        zkw = dict(holdoff=2 * const.trigger_window + 1,
                   trigger_window=const.trigger_window, max_intervals=K,
                   nonneg=True)
        zargs = (grid.reshape(B * R, T), zthr, *rows)
        zk = zle_all_channels(*zargs, **zkw)
        zr = zle_all_channels_ref(*zargs, **zkw)
        zerr = max(max_diff(a, b) for a, b in zip(zk, zr))
        print(f'[kernels-f] zle_intervals (full grid, nonneg): intervals '
              f'{int(zr[2].sum())} (HE rows '
              f'{int(zr[2].reshape(B, R)[:, he].sum())}), max|diff| {zerr}')
        if zerr:
            raise AssertionError('zle_intervals (nonneg) differs from its '
                                 'twin')
        del grid, grid_ref, zk, zr

        # ---- 4e. the he_full_grid main path ------------------------------
        out, wall, launches, peak, sim = timed_run(cfg, inst, dev)
        diag = sim.sim.rawdata.diag.summary()
        print(f'[full] launches {launches}')
        for name in FULL_GRID_PATH_KERNELS:
            if launches[name] <= 0:
                raise AssertionError(f'kernel {name} not launched on the '
                                     f'he_full_grid path')
        if (launches['wfsim_superpose_adc_full'] != diag['digitize_calls']
                or launches['wfsim_superpose_adc']):
            raise AssertionError('not every digitize batch ran the full grid')
        rr, rr_he, rr_aq = (out['raw_records'], out['raw_records_he'],
                            out['raw_records_aqmon'])
        truth = out['truth']
        n_top_rec = int((rr['channel'] < n_top).sum())
        n_type = {t: int((truth['type'] == t).sum()) for t in (1, 2, 4, 6)}
        print(f'[full] records per split: raw_records {len(rr)} (top array '
              f'{n_top_rec}), raw_records_he {len(rr_he)}, raw_records_aqmon '
              f'{len(rr_aq)}; truth rows by type {n_type}; windows '
              f'{diag["windows"]} in {diag["digitize_calls"]} batches')
        if not strax_valid(rr, C) or not len(rr_he) or len(rr_aq):
            raise AssertionError('he_full_grid records: invalid raw_records, '
                                 'empty raw_records_he or non-empty '
                                 'raw_records_aqmon')
        if not (rr_he['channel'].min() >= const.he_channel_start
                and rr_he['channel'].max() < he.stop
                and np.all(np.diff(rr_he['time']) >= 0)
                and rr_he['data'].min() >= 0):
            raise AssertionError('raw_records_he violate the strax '
                                 'invariants or leave channels 500-752')
        if abs(len(rr_he) - n_top_rec) > 0.05 * n_top_rec:
            raise AssertionError(f'HE records {len(rr_he)} not within 5 % of '
                                 f'the top-array records {n_top_rec}')
        if n_type[1] != 512 or n_type[2] != 512 or n_type[4] <= 0:
            raise AssertionError(f'truth rows by type {n_type}')
        n_photons = int(truth['n_photon'].sum())
        expect_records('he_full_grid', len(rr), len(rr_he), launches=launches)
        print(f'[full] events/s {512 / wall:.2f} wall {wall:.3f} s records '
              f'{len(rr) + len(rr_he) + len(rr_aq)} photons {n_photons} '
              f'peak_mem {peak / 2 ** 20:.1f} MiB ({smi})')
        print(f'[full] phases {diag}')

        # ---- 5e. one full-grid window batch: card against the CPU twins ---
        rd = RawData(cfg, device=dev)
        rd.simulate(inst)
        wins, arena_d, batches = rd.plan_digitize()
        # the longest windows up to T_cap 4096 (S2 windows), the batch with
        # the most of them, cut to 16 windows so the CPU twins stay quick
        cand = [b for b in batches if b[1] <= 4096] or batches
        batch, T_cap, pieces, nix_b = max(cand, key=lambda b: (b[1],
                                                               len(b[0])))
        batch, pieces, nix_b = batch[:16], pieces[:16], nix_b[:16]
        arena_c = [a.cpu() for a in arena_d]
        res = {}
        for name, d, ar in (('cuda', dev, arena_d),
                            ('cpu', torch.device('cpu'), arena_c)):
            prm = build_params(cfg, load_config(cfg), d)
            g = gather_digitize(prm, const, *ar, pieces,
                                torch.as_tensor(nix_b, device=d),
                                n_samples=T_cap, max_intervals=K)
            rec = pack_records(g['data'], g['left_all'], g['starts'],
                               g['ends'], g['counts'])
            res[name] = [x.cpu().numpy() for x in rec]
        same = all(a.shape == b.shape and np.array_equal(a, b)
                   for a, b in zip(res['cuda'], res['cpu']))
        meta = res['cuda'][1]
        n_he = int(((meta[:, 1] >= he.start) & (meta[:, 1] < he.stop)).sum())
        print(f'[cross-f] windows {len(batch)} T_cap {T_cap} rows {R} '
              f'records {len(meta)} (HE {n_he}) cuda==cpu {same}')
        if not same or not n_he:
            raise AssertionError('full-grid digitize on the card differs '
                                 'from the CPU twins (or has no HE record)')
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return launches


def phase_timing_models(dev, smi):
    """Phases 3f, 4f and 5f (see the module docstring); returns the
    measurements of the lumi_garfield_times rows (see garfield_measure)
    and the launch counts of the 4f run."""
    from wfsim_tpu_torch.config import default_config, timing_models_overrides
    from wfsim_tpu_torch.interface import (timing_models_instructions,
                                           TIMING_MODEL_RECOILS)
    from wfsim_tpu_torch.resources.synthetic import write_garfield_table
    tmp = tempfile.mkdtemp(prefix='wfsim_smoke_tm_')
    try:
        path = write_garfield_table(Path(tmp) / 'garfield.npz', 1234)
        cfg = default_config(seed=1234, chunk_size=100,
                             **timing_models_overrides(path))
        inst = timing_models_instructions(512, 2000, 300)
        params, const, batches = physics_batches(cfg, inst, dev, 20261016)
        print(f'[timing] garfield table {tuple(params.garfield_t.shape)} '
              f'(liquid level of {path}), int mean {params.garfield_avgt}')

        # ---- 3f. the garfield times against their twin ------------------
        res = garfield_measure(dev, smi)

        # ---- 4f. the timing_models main path --------------------------------
        out, wall, launches, peak, sim = timed_run(cfg, inst, dev)
        diag = sim.sim.rawdata.diag.summary()
        print(f'[timing] launches {launches}')
        for name in TIMING_PATH_KERNELS:
            if launches[name] <= 0:
                raise AssertionError(f'kernel {name} not launched on the '
                                     f'timing_models path')
        if launches['wfsim_lumi_tables']:
            raise AssertionError('the simple luminescence tables ran')
        rr, truth = out['raw_records'], out['truth']
        n_type = {t: int((truth['type'] == t).sum()) for t in (1, 2)}
        if n_type != {1: 512, 2: 512} or len(truth) != len(inst):
            raise AssertionError(f'timing_models truth rows {n_type}')
        s1_rows = truth[truth['type'] == 1]
        dt = s1_rows['t_mean_photon'] - s1_rows['time']
        by_cls = {int(r): float(np.mean(dt[s1_rows['recoil'] == r]))
                  for r in TIMING_MODEL_RECOILS}
        s2_rows = truth[truth['type'] == 2]
        lit = s2_rows['n_photon'] > 0
        print(f'[timing] truth rows by type {n_type}; S1 photon-time mean '
              f'after the instruction by recoil id {by_cls} ns; S2 rows with '
              f'photons {int(lit.sum())}, t_sigma_photon min '
              f'{float(s2_rows["t_sigma_photon"][lit].min()):.3f} ns')
        if not by_cls[0] < by_cls[7]:
            raise AssertionError('NR S1 photons not earlier than ER ones')
        if not np.all(s2_rows['t_sigma_photon'][lit] > 0):
            raise AssertionError('an S2 truth row with photons has no time '
                                 'spread')
        if not strax_valid(rr, const.n_tpc_pmts):
            raise AssertionError('timing_models raw_records violate the '
                                 'strax invariants')
        n_photons = int(truth['n_photon'].sum())
        expect_records('timing_models', len(rr), launches=launches)
        print(f'[timing] events/s {512 / wall:.2f} wall {wall:.3f} s '
              f'records {len(rr)} photons {n_photons} peak_mem '
              f'{peak / 2 ** 20:.1f} MiB ({smi})')
        print(f'[timing] phases {diag}')

        # ---- 5f. the passes: card against the CPU twins ---------------------
        phase_5c(cfg, params, const, batches, smi, tag='cross-t')
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return res, launches


def field_maps_lookups(params, const, batches):
    """The map lookups (K12a) of the field_maps path at its own shapes:
    {row: (map, points)}: the S1 spline (top) at the S1 batch's photons
    (z, u), the S2 spline (top) at the S2 batch's photons (u), the
    drift-speed and COMSOL (r, z) maps at the S2 instructions, the gas-gap
    and se-gain (x, y) maps at their observed and interaction positions."""
    import torch
    from wfsim_tpu_torch.models import s2
    x1, _n1, d1 = batches['s1']
    x2, _n2, d2 = batches['s2']
    n1 = int(d1['u_ch'].shape[0])
    z_ph = torch.repeat_interleave(x1['z'], d1['n_hits'].to(torch.int64),
                                   output_size=n1)
    xy = torch.stack([x2['x'], x2['y']], dim=1)
    rz = torch.stack([torch.sqrt(x2['x'] ** 2 + x2['y'] ** 2), x2['z']],
                     dim=1)
    return dict(
        grid_lookup_s1_spline=(params.s1_prop_top,
                               torch.stack([z_ph, d1['u_prop']], dim=1)),
        grid_lookup_s2_spline=(params.s2_prop_top,
                               d2['u_prop'][:, None].contiguous()),
        grid_lookup_drift_speed=(params.drift_speed_map, rz),
        grid_lookup_comsol=(params.fd_comsol, rz),
        grid_lookup_gas_gap=(params.gas_gap_map,
                             s2.s2_positions(params, const, x2)[1]),
        grid_lookup_se_gain=(params.se_gain, xy.contiguous()))


def pass_syncs(params, const, batches):
    """Host syncs of the S1 and S2 photon passes of one batch each (see
    count_syncs): {kind: (count, lines)}."""
    from wfsim_tpu_torch.models.s1 import s1_photon_pass
    from wfsim_tpu_torch.models.s2 import s2_photon_pass
    out = {}
    for kind, fn in (('s1', s1_photon_pass), ('s2', s2_photon_pass)):
        x, n_rows, draws = batches[kind]
        out[kind] = count_syncs(lambda: fn(params, const, x, draws,
                                           n_truth_rows=n_rows))
    return out


def phase_field_maps(dev, smi):
    """Phases 3q, 4q and 5q: the field_maps configuration (S1 and S2
    optical propagation splines, COMSOL field distortion, gas-gap warping,
    every field-dependency map, the se-gain and extraction maps, read from
    the synthetic files of ``write_field_maps`` in a temporary directory)
    on the bench workload.

    3q. the map lookup (K12a) at the path's new call sites
        (field_maps_lookups) and the luminescence tables (K6) with the
        gas gap of each S2 instruction (``dG``), each against its twin on
        the card, bitwise, with the library call for the lookups
        (grid_sample_library) and the wrapper's host time; the S1 and S2
        passes' read-backs a batch, at most the default configuration's;
    4q. main path: ``Simulator(default_config(seed=1234, chunk_size=100,
        **field_maps_overrides(dir)), device='cuda').get_arrays(inst)``,
        warm-up then timed; every entry of the path launched, the records
        and launches as expected; the truth's electrons within the maps'
        extraction, COMSOL's mean electron positions inside the
        interactions' radius;
    5q. the S1 and S2 batches through the kernels on the card and, from
        the same draws, through the twins on the CPU.

    Returns (the 3q measurements, the 4q launch counts)."""
    import torch
    from wfsim_tpu_torch.config import default_config, field_maps_overrides
    from wfsim_tpu_torch.interface import bench_instructions
    from wfsim_tpu_torch.models import s2
    from wfsim_tpu_torch.models.params import build_constants
    from wfsim_tpu_torch.resources.synthetic import write_field_maps
    from wfsim_tpu_torch.ops.interp import grid_lookup_ref
    tmp = tempfile.mkdtemp(prefix='wfsim_smoke_fm_')
    try:
        write_field_maps(tmp, 1234)
        cfg = default_config(seed=1234, chunk_size=100,
                             **field_maps_overrides(tmp))
        inst = bench_instructions(512, 2000, 300)
        params, const, batches = physics_batches(cfg, inst, dev, 20261016)
        x2, _n2, d2 = batches['s2']
        n_s1 = int(batches['s1'][2]['u_ch'].shape[0])
        n_e, n_ph = int(d2['n_electron'].sum()), int(d2['u_ch'].shape[0])
        print(f'[field-maps] S1 batch {n_s1} photons; S2 batch '
              f'{int(x2["x"].shape[0])} instructions, {n_e} electrons, '
              f'{n_ph} photons; drift velocity scaling '
              f'{const.drift_velocity_scaling}')

        # ---- 3q. the lookups and the warped luminescence tables ----------
        res = {}
        check = make_check(res, 'kernels-q', smi)
        for name, (gmap, pts) in field_maps_lookups(params, const,
                                                    batches).items():
            n, d = pts.shape
            out_dim = int(gmap.values.shape[-1])
            check(name, lambda m=gmap, p=pts: (m(p),),
                  lambda m=gmap, p=pts: (grid_lookup_ref(
                      m.values, m.lows, m.highs, p),),
                  (gmap, pts),
                  ops32=n * (d * 6 + out_dim * 2 ** d * (d + 1)),
                  library=grid_sample_library(gmap, pts), host=True)
            print(f'[kernels-q] {name}: map {tuple(gmap.values.shape)}, '
                  f'{n} points')
        _z, xy_obs = s2.s2_positions(params, const, x2)
        dG = params.gas_gap_map(xy_obs).contiguous()
        n_i = int(dG.shape[0])
        want = int(s2.lumi_sequential_rows_ref(const, n_i, dev, dG).sum())
        n_bytes, ops32, ops64, _o32, _o64 = lumi_work(const, n_i, dG)
        # what the kernel reads: the radius, reciprocal and quantile
        # grids, each row's gap and field (lumi_work's bytes)
        reads = (*s2._lumi_inputs(const, dev)[:3], dG,
                 s2._anode_field(const, n_i, dev, dG)[1])
        check('lumi_tables_warped',
              lambda: (s2.luminescence_tables(const, n_i, dev, dG),),
              lambda: (s2.luminescence_tables_ref(const, n_i, dev, dG),),
              reads, ops32=ops32, ops64=ops64, host=True)
        if res['lumi_tables_warped']['bytes'] != n_bytes:
            raise AssertionError('lumi_tables_warped: bytes off lumi_work')
        print(f'[kernels-q] lumi_tables_warped: {n_i} rows, gas gaps '
              f'{float(dG.min()):.5f}-{float(dG.max()):.5f} cm, sequential '
              f'rows by the twin {want}; bytes {n_bytes}, bound '
              f'{bound(n_bytes, ops32, ops64)[0]:.6f} ms')
        if want:
            raise AssertionError('warped gas gaps on the sequential pass')
        cfg0 = default_config(seed=1234, chunk_size=100)
        params0, const0, batches0 = physics_batches(cfg0, inst, dev,
                                                    20261016)
        syncs, syncs0 = (pass_syncs(params, const, batches),
                         pass_syncs(params0, const0, batches0))
        print(f'[field-maps] read-backs a batch: S1 {syncs["s1"]}, S2 '
              f'{syncs["s2"]}; default S1 {syncs0["s1"][0]}, S2 '
              f'{syncs0["s2"][0]}')
        for kind in ('s1', 's2'):
            if syncs[kind][0] > syncs0[kind][0]:
                raise AssertionError(f'field_maps {kind} pass reads back '
                                     f'more than the default one')
        del params0, batches0

        # ---- 4q. the field_maps main path ---------------------------------
        out, wall, launches, peak, sim = timed_run(cfg, inst, dev)
        diag = sim.sim.rawdata.diag.summary()
        print(f'[field-maps] launches {launches}')
        for name in FIELD_MAPS_PATH_KERNELS:
            if launches[name] <= 0:
                raise AssertionError(f'kernel {name} not launched on the '
                                     f'field_maps path')
        rr, truth = out['raw_records'], out['truth']
        n_type = {t: int((truth['type'] == t).sum()) for t in (1, 2)}
        if n_type != {1: 512, 2: 512} or len(truth) != len(inst):
            raise AssertionError(f'field_maps truth rows {n_type}')
        s2_rows = truth[truth['type'] == 2]
        r_shift = (np.hypot(s2_rows['x'], s2_rows['y'])
                   - np.hypot(s2_rows['x_mean_electron'],
                              s2_rows['y_mean_electron']))
        frac = s2_rows['n_electron'] / 300
        print(f'[field-maps] truth rows by type {n_type}; electrons a '
              f'300-electron S2 {frac.min():.3f}-{frac.max():.3f}; COMSOL '
              f'radius shift {r_shift.min():.4f}-{r_shift.max():.4f} cm; '
              f'S2 photons {int(s2_rows["n_photon"].sum())}')
        if not (np.all(np.isfinite(r_shift)) and np.all(r_shift >= 0)
                and np.all(r_shift < 5)):
            raise AssertionError('COMSOL mean electron positions off')
        if not (0.2 < frac.mean() < 0.7):
            raise AssertionError('S2 electrons off the maps\' extraction')
        if not strax_valid(rr, const.n_tpc_pmts):
            raise AssertionError('field_maps raw_records violate the strax '
                                 'invariants')
        expect_records('field_maps', len(rr), launches=launches)
        print(f'[field-maps] events/s {512 / wall:.2f} wall {wall:.3f} s '
              f'records {len(rr)} photons {int(truth["n_photon"].sum())} '
              f'peak_mem {peak / 2 ** 20:.1f} MiB ({smi})')
        print(f'[field-maps] phases {diag}')

        # ---- 5q. the passes: card against the CPU twins ----------------
        phase_5c(cfg, params, const, batches, smi, tag='cross-q')
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return res, launches


def timed_run(cfg, inst, dev, mesh_fn=lambda: None, warm_inst=None):
    """A warm-up ``get_arrays`` (on ``warm_inst``, by default ``inst``),
    then a timed one on ``inst`` with every launch count set to 0 just
    before, each Simulator over ``mesh_fn()`` (default: no mesh); returns
    (out, wall_s, launches, peak device bytes, the timed Simulator)."""
    import torch
    from wfsim_tpu_torch import Simulator, _build
    Simulator(cfg, device=dev, mesh=mesh_fn()).get_arrays(
        inst if warm_inst is None else warm_inst)          # warm-up
    sim = Simulator(cfg, device=dev, mesh=mesh_fn())
    torch.cuda.synchronize()
    for k in _build.KERNELS.values():
        k.launches = 0
    zero_second_pass()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    out = sim.get_arrays(inst)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: k.launches for name, k in _build.KERNELS.items()}
    return out, wall, launches, torch.cuda.max_memory_allocated(dev), sim


#: the records of each configuration's 512-event run (seed 1234) on an
#: H100 80GB HBM3, and (he_full_grid) its raw_records_he; a change that
#: keeps every kernel's output keeps them (the optical runs': 522
#: instructions from 512 GEANT4 events, see OPTICAL_CONFIGS)
EXPECTED_RECORDS = dict(default=840_728, realistic=867_836,
                        detector_physics=768_746,
                        he_full_grid=(868_127, 444_017),
                        timing_models=855_569, per_pmt_truth=867_836,
                        xenon1t_full_grid=567_294, field_maps=696_517,
                        optical_nveto=126_763, optical_tpc=110_106)
#: the launches of the channel draw, the map lookup, (one a digitize
#: batch) K17, the ZLE and record-pack entries, (one a digitize round) the
#: record rows, (one a simulation batch) the luminescence tables, the
#: PMT-afterpulse and photon-summary entries and the diffused pattern on
#: those runs
ROUNDS = dict.fromkeys(ROUND_KERNELS, 3)
EXPECTED_LAUNCHES = dict(
    default=dict(wfsim_channel_draw=6, wfsim_grid_lookup=12,
                 wfsim_lumi_tables=3, wfsim_s2_electron_times=3,
                 wfsim_s2_photon_times=3,
                 **dict.fromkeys(WINDOW_KERNELS + ZLE_PACK_KERNELS, 15),
                 **ROUNDS),
    realistic=dict(**dict.fromkeys(AP_KERNELS, 9),
                   **dict.fromkeys(SUMMARY_KERNELS, 3),
                   **dict.fromkeys(WINDOW_KERNELS, 22), **ROUNDS),
    detector_physics=dict(wfsim_grid_lookup=30, wfsim_pattern_diffuse=3,
                          wfsim_lumi_gasgap_times=3,
                          wfsim_s2_photon_times=3,
                          **dict.fromkeys(WINDOW_KERNELS, 15), **ROUNDS),
    he_full_grid=dict(**dict.fromkeys(WINDOW_KERNELS, 23), **ROUNDS),
    timing_models=dict(**dict.fromkeys(WINDOW_KERNELS, 13), **ROUNDS),
    per_pmt_truth=dict(**dict.fromkeys(WINDOW_KERNELS, 22), **ROUNDS),
    xenon1t_full_grid=dict(**dict.fromkeys(WINDOW_KERNELS, 23), **ROUNDS),
    field_maps=dict(wfsim_grid_lookup=57, wfsim_lumi_tables=3,
                    wfsim_pattern_diffuse=3,
                    **dict.fromkeys(WINDOW_KERNELS, 15), **ROUNDS),
    optical_nveto=dict(wfsim_pmt_photon_pass=6, wfsim_pmt_row_truth=6,
                       **dict.fromkeys(AP_KERNELS, 6),
                       **dict.fromkeys(WINDOW_KERNELS + ZLE_PACK_KERNELS, 9),
                       **ROUNDS),
    optical_tpc=dict(wfsim_pmt_photon_pass=6, wfsim_pmt_row_truth=6,
                     wfsim_pmt_row_truth_per_pmt=6,
                     **dict.fromkeys(WINDOW_KERNELS + ZLE_PACK_KERNELS, 10),
                     **ROUNDS))
#: run_digest of the default run's arrays on that card
DEFAULT_DIGEST = (
    '0a865a49983e43b443ffbd1579cd7ef589ce90090fa452211babf6fb6df94264')


def run_digest(out):
    """One sha256 over the digests of a ``get_arrays`` result's arrays."""
    return hashlib.sha256(repr(arrays_digest(out)).encode()).hexdigest()


def expect_records(name, *records, launches=None, digest=None):
    """Raise unless a configuration's run gives EXPECTED_RECORDS, the
    EXPECTED_LAUNCHES and (default) DEFAULT_DIGEST, no luminescence
    row since phase 3m's failing constants was integrated on the kernel's
    sequential pass, and no truth row of the run took the truth kernels'
    second pass."""
    expect_no_sequential_rows(name)
    expect_no_second_pass(name)
    # K17 once a digitize batch, as the ZLE (on every configuration)
    batches = launches['wfsim_zle_intervals']
    print(f'[expect] {name}: digitize batches {batches}, K17 launches '
          f'{launches["wfsim_window_rows"]}')
    if batches <= 0 or launches['wfsim_window_rows'] != batches:
        raise AssertionError(f'{name}: K17 launched '
                             f'{launches["wfsim_window_rows"]} times in '
                             f'{batches} digitize batches')
    want = EXPECTED_RECORDS[name]
    want = want if isinstance(want, tuple) else (want,)
    got = {e: launches[e] for e in EXPECTED_LAUNCHES.get(name, {})}
    print(f'[expect] {name}: records {records} (expected {want}), launches '
          f'{got} (expected {EXPECTED_LAUNCHES.get(name, {})})'
          + ('' if digest is None else f', digest {digest} (expected '
             f'{DEFAULT_DIGEST})'))
    if (records != want or got != EXPECTED_LAUNCHES.get(name, {})
            or digest != (DEFAULT_DIGEST if digest else None)):
        raise AssertionError(f'{name}: the run differs from the expected '
                             f'records, launches or digest')


def zero_second_pass():
    """Zero the truth kernels' second-pass counts (where the checkout's
    package has them)."""
    from wfsim_tpu_torch.models import pmt
    if hasattr(pmt, 'pmt_truth_second_pass'):
        pmt.pmt_truth_second_pass('cuda:0').zero_()


def expect_no_second_pass(where):
    """Raise unless the truth kernels' second-pass counts (since they were
    last zeroed) are 0: no row of the run left the exact integer sums."""
    from wfsim_tpu_torch.models import pmt
    n = pmt.pmt_truth_second_pass('cuda:0').tolist()
    print(f'[expect] {where}: truth rows on the float64 second pass {n}')
    if any(n):
        raise AssertionError(f'{where}: {n} truth rows on the second pass')


def expect_no_sequential_rows(where):
    """Raise unless the luminescence kernel's count of rows on its
    sequential pass (``lumi_sequential_rows``, since it was last zeroed)
    is 0."""
    from wfsim_tpu_torch.models.s2 import lumi_sequential_rows
    n = int(lumi_sequential_rows('cuda:0'))
    print(f'[expect] {where}: luminescence rows on the sequential pass {n}')
    if n:
        raise AssertionError(f'{where}: {n} luminescence rows on the '
                             f'sequential pass')


def same_arrays(a, b):
    """Whether two ``get_arrays`` results hold the same keys and bytes."""
    return sorted(a) == sorted(b) and all(
        a[k].tobytes() == b[k].tobytes() for k in a)


def check_per_pmt(truth, off, n_top, tag):
    """The per-PMT vectors of ``truth`` sum over the channels to its
    totals and over the bottom array (channels >= n_top) to the bottom
    fields of ``off``, the same run without per-PMT truth: counts
    exactly, raw areas within rtol 1e-12.  Returns the largest relative
    difference of the areas."""
    if not (np.array_equal(truth['time'], off['time'])
            and np.array_equal(truth['type'], off['type'])):
        raise AssertionError(f'{tag}: truth rows differ from the run '
                             f'without per-PMT truth')
    worst = 0.0
    for name in ('n_photon', 'n_pe', 'n_photon_trigger', 'n_pe_trigger',
                 'raw_area', 'raw_area_trigger'):
        per = truth[name + '_per_pmt']
        for got, want in ((per.sum(1), truth[name]),
                          (per[:, n_top:].sum(1), off[name + '_bottom'])):
            if name.startswith('raw_area'):
                rel = float(np.max(np.abs(got - want)
                                   / np.maximum(np.abs(want), 1e-300)))
                worst = max(worst, rel)
                ok = rel <= 1e-12
            else:
                ok = np.array_equal(got, want)
            if not ok:
                raise AssertionError(f'{tag}: per-PMT {name} does not sum '
                                     f'to the row or bottom-array field')
    return worst


#: the per-PMT raw areas, compared within rtol 1e-12 (float64 atomics)
PER_PMT_AREAS = ('raw_area_per_pmt', 'raw_area_trigger_per_pmt')


def per_pmt_kernel_check(check, name, cfg, inst, dev):
    """K16 against its twin on the 512-instruction S2 batch of ``cfg``
    (the photons after the PMT photon pass); the library computation is
    per_pmt_library's, held against the twin too (counts exactly, areas
    within rtol 1e-12)."""
    from wfsim_tpu_torch.models import pmt, s2
    from wfsim_tpu_torch.models.s1 import row_edges_of
    params, const, batches = physics_batches(cfg, inst, dev, 20261016)
    x2, n_rows, d2 = batches['s2']
    ph, _truth, _req = s2.s2_photon_pass(params, const, x2, d2,
                                         n_truth_rows=n_rows)
    row_edges = row_edges_of(x2['truth_row'], s2.s2_edges(d2)[2], n_rows)
    C = int(params.gains.shape[0])
    n_ph, n_valid = int(ph['t'].shape[0]), int(ph['valid'].sum())
    library = per_pmt_library(params, const, ph, row_edges)
    lib_err = compare(library(), tuple(pmt.pulse_truth_per_pmt_ref(
        params, const, ph, row_edges).values()), name + ' library',
        rtol_keys=(4, 5))
    check(name, lambda: pmt.pulse_truth_per_pmt(params, const, ph,
                                                row_edges),
          lambda: pmt.pulse_truth_per_pmt_ref(params, const, ph, row_edges),
          (*(ph[k] for k in ('t', 'ch', 'gain', 'is_dpe', 'valid')),
           row_edges, params.chan_pack, params.current_max),
          ops32=n_ph * 8 + n_valid * 4, ops64=n_valid * 2,
          rtol_keys=PER_PMT_AREAS, library=library)
    print(f'[kernels-x] {name}: {n_ph} photons ({n_valid} valid) in '
          f'{n_rows} rows x {C} channels; library computation against the '
          f'twin: max|diff| {lib_err}')


def count_syncs(fn):
    """Host syncs of one call of ``fn``: the warnings torch gives under
    ``torch.cuda.set_sync_debug_mode('warn')``, one a synchronizing
    operation (a read-back); returns (count, the Python lines that
    synced)."""
    import warnings
    import torch
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter('always')
        torch.cuda.set_sync_debug_mode('warn')
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode('default')
    torch.cuda.synchronize()
    lines = [f'{Path(w.filename).name}:{w.lineno}' for w in caught
             if 'called a synchronizing CUDA operation' in str(w.message)]
    return len(lines), lines


#: the superposition rows' window batches: the bench batch (16 windows of
#: one bench S2 each, 2048 samples), the skewed one (window 0 holds one S2
#: of 10^6 photons, ~2,000 a row on 494 channels: a high-energy deposit)
#: and the long one (8195 samples, not a multiple of 8, photons over the
#: whole window: 9 of a warp's 1,024-sample tiles a row)
SUPERPOSE_SHAPES = dict(bench=(2048, 4600, 1500), skewed=(2048, 4600, 1500),
                        long=(8195, 4600, 20000))
SKEWED_PHOTONS = 1_000_000


def superpose_arena(shape, n_ch, seed, B=16):
    """(t, ch, gain, pieces, T) of one SUPERPOSE_SHAPES batch."""
    T, n_mean, sigma = SUPERPOSE_SHAPES[shape]
    rng = np.random.default_rng(seed)
    t, ch, g, pieces = s2_like_arena(rng, B, n_ch, T, n_mean, sigma)
    if shape == 'skewed':
        t0, ch0, g0, _ = s2_like_arena(rng, 1, n_ch, T, SKEWED_PHOTONS,
                                       sigma)
        n0 = int(pieces[0, 0, 1])
        t, ch, g = (np.concatenate([a0, a[n0:]])
                    for a0, a in ((t0, t), (ch0, ch), (g0, g)))
        pieces[1:, 0, 0] += len(t0) - n0
        pieces[0, 0, 1] = len(t0)
    return t, ch, g, pieces, T


#: the superposition's library computations (superpose_library): the
#: gain histogram through ``conv1d`` and the taps scattered by
#: ``index_add_`` (cuDNN's autotuner picks the same one-output-channel
#: conv kernel as its heuristic on an H100, so it is not a third)
SUPERPOSE_LIBRARY = ('conv1d', 'index_add')


def library_waveform(t, gain, row_ptr, templates, T, how):
    """A call that returns the float32 (rows, T) waveform of row-sorted
    photons in PyTorch around one library call: ``how`` 'conv1d', the
    float32 histogram ``H[row, r, s]`` of the gains (``index_put_`` with
    accumulate; s = t // dt, r = t % dt, L - 1 samples of padding before
    sample 0 and a dump column for photons past the grid) through
    ``F.conv1d`` with the flipped template bank, sliced to T; 'index_add',
    each photon's L products ``gain * T[r][k]`` added into its row at
    samples s + k by one ``index_add_`` (a dump past sample T).  Only the
    padded index layout (each photon's row offset) is computed outside
    the returned call.  cuDNN's TF32 is off inside the call; the adds'
    order is not the twins' (per bin first, or atomics)."""
    import torch
    import torch.nn.functional as F
    dev = t.device
    dt, L = templates.shape
    n_rows = row_ptr.shape[0] - 1
    # conv1d: L - 1 padding, T samples, the dump; index_add: T samples and
    # L - 1 + 1 past them, where a photon at s >= T is moved to s = T
    width = T + L
    counts = (row_ptr[1:] - row_ptr[:-1]).to(torch.int64)
    rows = torch.arange(n_rows, device=dev)
    row_off = torch.repeat_interleave(
        rows * (width if how == 'index_add' else dt * width), counts,
        output_size=t.shape[0])
    weight = templates.flip(1)[None].contiguous()
    taps = torch.arange(L, device=dev)

    def superpose():
        s = torch.div(t, dt, rounding_mode='floor')
        if how == 'index_add':
            idx = (row_off + s.clamp_max(T))[:, None] + taps
            G = torch.zeros(n_rows * width, device=dev)
            G.index_add_(0, idx.view(-1),
                         (gain[:, None] * templates[t - s * dt]).view(-1))
            return G.view(n_rows, width)[:, :T]
        idx = (row_off + (t - s * dt) * width
               + torch.where(s < T, s + (L - 1), width - 1))
        H = torch.zeros(n_rows * dt * width, device=dev)
        H.index_put_((idx,), gain, accumulate=True)
        with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                        deterministic=False,
                                        allow_tf32=False):
            return F.conv1d(H.view(n_rows, dt, width), weight)[:, 0, :T]
    return superpose


def superpose_library(sargs, kw, C, full=None, how='conv1d'):
    """One superposition entry in PyTorch around one library call: the
    waveform of ``library_waveform``, then the epilogue in torch: round,
    noise gather, baseline, clip, int16; with ``full`` = (n_all, n_top,
    he_lo, sum_ch, deamp) the full grid (he_lo None: without HE rows) with
    the HE rows and the bottom sum.  Only the padded index layout (each
    photon's row offset, each row's window and channel) is computed
    outside the returned call, and nothing is read back; the result is not
    bitwise the twin's (see library_waveform)."""
    import torch
    t, gain, row_ptr, templates, ch_left, ch_right, has = sargs
    dev = t.device
    T = kw['n_samples']
    n_rows = row_ptr.shape[0] - 1
    B = n_rows // C
    superpose = library_waveform(t, gain, row_ptr, templates, T, how)
    rows = torch.arange(n_rows, device=dev)
    w_row, c_row = rows // C, rows % C
    u = torch.arange(T, device=dev)
    c2a = float(np.float32(kw['current_2_adc']))
    base = kw['baseline']
    bank, nix = kw.get('noise_bank'), kw.get('noise_ix')

    top = rows[c_row < (full[1] if full else 0)]

    def epilogue(x, in_win, sel, cols):
        """Rows ``sel`` of the grid: x plus, in the window, the reads of
        bank column ``cols`` (0 past the bank) and the baseline, clipped."""
        add = base
        if bank is not None:
            Cn, Lb = bank.shape
            pos = torch.remainder(nix[w_row[sel]][:, None] + u[None, :]
                                  - ch_left[sel][:, None], Lb)
            val = bank.reshape(-1)[cols.clamp_max(Cn - 1)[:, None] * Lb
                                   + pos]
            add = torch.where((cols < Cn)[:, None], val.to(torch.int32),
                              0) + base
        x = x + torch.where(in_win, add, 0)
        return torch.where(in_win, torch.clamp_min(x, 0), x)

    def call():
        adc = (-torch.round(superpose() * c2a)).to(torch.int32)
        in_win = ((u[None, :] >= ch_left[:, None])
                  & (u[None, :] <= ch_right[:, None]) & has[:, None])
        tpc = epilogue(adc, in_win, rows, c_row).to(torch.int16)
        if full is None:
            return tpc
        n_all, n_top, he_lo, sum_ch, deamp = full
        out = torch.zeros((B, n_all, T), dtype=torch.int16, device=dev)
        out[:, :C] = tpc.view(B, C, T)
        if he_lo is not None:
            he = adc * deamp
            out[:, he_lo:he_lo + n_top] = epilogue(
                he[top], in_win[top], top, he_lo + c_row[top]).view(
                B, n_top, T).to(torch.int16)
            out[:, sum_ch] = he.view(B, C, T)[:, n_top:].sum(dim=1).to(
                torch.int16)
        return out
    return call


def superpose_measure(dev, smi, max_syncs=1):
    """The four superposition rows (slim K1+K2, slim with noise K10, the
    full grid with and without HE rows) on each batch of ``shapes``: each
    kernel bitwise against its twin, its host syncs a call (at most one),
    ``ms``, ``device_ms``, ``host_us`` over 1,000 calls, the twin's time,
    the bound and the library computations of SUPERPOSE_LIBRARY (each
    one's time, device time by kernel, samples that differ from the
    twin's and peak device memory; the fastest is ``library_ms``).
    Returns {row name: measurements (see make_check)}; a row off the bench
    batch is named with the batch as a suffix.  ``max_syncs`` None counts
    the read-backs without a limit (another checkout's wrappers)."""
    import torch
    from wfsim_tpu_torch.config import default_config
    from wfsim_tpu_torch.models.params import build_params, build_constants
    from wfsim_tpu_torch.ops.waveform import (
        superpose_adc, superpose_adc_ref, superpose_adc_full,
        superpose_adc_full_ref)
    from wfsim_tpu_torch.pipeline.digitize import window_photons
    from wfsim_tpu_torch.resources import load_config
    from wfsim_tpu_torch.resources.synthetic import synthetic_noise
    realism = dict(enable_noise=True, enable_pmt_afterpulses=True,
                   enable_electron_afterpulses=True)
    cfg_r = default_config(seed=1234, chunk_size=100, **realism)
    cfg_x = default_config(detector='XENON1T', seed=1234, chunk_size=100,
                           high_energy_deamplification_factor=1.0, **realism)
    const_r, const_x = build_constants(cfg_r), build_constants(cfg_x)
    params_r = build_params(cfg_r, load_config(cfg_r), dev)
    params_x = build_params(cfg_x, load_config(cfg_x), dev)
    # the he_full_grid bank: 801 columns of the production file's length
    bank801 = torch.as_tensor(np.ascontiguousarray(
        synthetic_noise(const_r.n_channels_total, 100_000, seed=801).T
        .astype(np.int16)), device=dev)
    res = {}
    for shape in SUPERPOSE_SHAPES:
        for name, const, params, bank, full in (
                ('superpose_adc', const_r, params_r, None, False),
                ('superpose_adc_noise', const_r, params_r,
                 params_r.noise_bank, False),
                ('superpose_adc_full', const_r, params_r, bank801, True),
                ('superpose_adc_full_no_he', const_x, params_x,
                 params_x.noise_bank, True)):
            C, R, n_top = (const.n_tpc_pmts, const.n_channels_total,
                           const.n_top_pmts)
            t_np, ch_np, g_np, pieces, T = superpose_arena(shape, C,
                                                           20261016)
            B = len(pieces)
            ph = window_photons(const, *(torch.as_tensor(a, device=dev)
                                         for a in (t_np, ch_np, g_np)),
                                pieces, n_samples=T)
            sargs = (ph['t'], ph['gain'], ph['row_ptr'], params.templates,
                     ph['ch_left'], ph['ch_right'], ph['has'])
            kw = dict(current_2_adc=const.current_2_adc,
                      baseline=const.digitizer_reference_baseline,
                      n_samples=T)
            nix = None
            if bank is not None:
                Lb = int(bank.shape[1])
                nix = torch.as_tensor(Lb - T // 2 + np.arange(B) * 7,
                                      dtype=torch.int32, device=dev)
                kw.update(noise_bank=bank, noise_ix=nix)
            he = full and const.detector == 'XENONnT'
            layout = None
            if full:
                kw.update(n_channels=C, n_channels_total=R, n_top=n_top,
                          he_start=const.he_channel_start if he else None,
                          sum_channel=const.sum_signal_channel if he
                          else None, deamp=const.high_energy_deamp_int)
                layout = (R, n_top, kw['he_start'], kw['sum_channel'],
                          kw['deamp'])
                fn, twin = superpose_adc_full, superpose_adc_full_ref
            else:
                if bank is not None:
                    kw['n_channels'] = C
                fn, twin = superpose_adc, superpose_adc_ref
            # bytes: the inputs, the int16 grid and an int16 bank read per
            # in-window sample of every banked row (TPC rows, and on the
            # full grid with HE rows their copies); operations: a template
            # tap per photon, the epilogue per TPC sample, the HE epilogue
            # or the bottom sum
            n_ph = int(sargs[0].shape[0])
            span = torch.where(ph['has'], ph['ch_right'] - ph['ch_left'] + 1,
                               0).reshape(B, C)
            n_reads = 0
            if bank is not None:
                n_reads = int(span[:, :min(C, int(bank.shape[0]))].sum())
                if he:
                    n_reads += int(span[:, :n_top].sum())
            kernel = lambda f=fn, a=sargs, k=kw: f(*a, **k)      # noqa: E731
            plain = lambda f=twin, a=sargs, k=kw: f(*a, **k)     # noqa: E731
            out = kernel()
            ref = plain()
            n_diff = int((out != ref).sum())
            row = name + ('' if shape == 'bench' else f'_{shape}')
            syncs, where = count_syncs(kernel)
            print(f'[superpose] {row}: {B} x {tuple(out.shape)[-2:]} '
                  f'({n_ph} photons, largest row '
                  f'{int((sargs[2][1:] - sargs[2][:-1]).max())}), samples '
                  f'differing from the twin {n_diff}, host syncs a call '
                  f'{syncs} {where}')
            if n_diff or (max_syncs is not None and syncs > max_syncs):
                raise AssertionError(f'{row}: the kernel differs from its '
                                     f'twin or reads back more than once')
            libs = {}
            for how in SUPERPOSE_LIBRARY:
                library = superpose_library(sargs, kw, C, layout, how)
                library()
                torch.cuda.synchronize()
                before = torch.cuda.memory_allocated(dev)
                torch.cuda.reset_peak_memory_stats(dev)
                lib_out = library()
                torch.cuda.synchronize()
                peak = torch.cuda.max_memory_allocated(dev) - before
                lib_diff = int((lib_out != ref).sum())
                del lib_out
                lib_dev, lib_split = device_ms(library, reps=10)
                libs[how] = dict(ms=cuda_ms(library), diff=lib_diff,
                                 peak_mib=peak / 2 ** 20, device_ms=lib_dev,
                                 split=lib_split)
                del library
            del out, ref
            fastest = min(libs, key=lambda h: libs[h]['ms'])
            L_t = int(params.templates.shape[1])
            ops = n_ph * L_t * 2 + B * C * T * 3 + n_reads
            if he:
                ops += B * n_top * T * 4 + B * (C - n_top) * T * 2
            dev_ms, by_name = device_ms(kernel)
            m = res[row] = dict(
                err=n_diff, ms=cuda_ms(kernel), device_ms=dev_ms,
                plain_ms=cuda_ms(plain, reps=5), host_us=host_us(kernel,
                                                                 1000),
                bytes=nbytes(sargs, nix) + 2 * B * (R if full else C) * T
                + 2 * n_reads, ops32=ops, ops64=0,
                library_ms=libs[fastest]['ms'], library_call=fastest,
                library_calls={h: v['ms'] for h, v in libs.items()},
                library_diff=libs[fastest]['diff'],
                library_peak_mib=libs[fastest]['peak_mib'], syncs=syncs,
                photons=n_ph, shape=shape)
            b_ms, b_by = bound(m['bytes'], ops)
            dev_s = ('not measured' if dev_ms is None else f'{dev_ms:.4f} ms '
                     + str({k: round(v, 6) for k, v in by_name.items()}))
            print(f'[superpose] {row}: {m["ms"]:.4f} ms, device {dev_s}, '
                  f'host {m["host_us"]:.2f} us a call, plain twin '
                  f'{m["plain_ms"]:.4f} ms, library call {fastest} '
                  f'{m["library_ms"]:.4f} ms, bound {b_ms:.6f} ms by {b_by} '
                  f'({smi})')
            for how, v in libs.items():
                split = {}
                for k, x in v['split'].items():
                    split[k[:60]] = split.get(k[:60], 0.0) + x
                top = sorted(split.items(), key=lambda kv: -kv[1])[:6]
                print(f'[superpose] {row} library {how}: {v["ms"]:.4f} ms, '
                      f'device {fmt_ms(v["device_ms"])}, '
                      f'{v["diff"]} samples differ from the twin, peak '
                      f'{v["peak_mib"]:.1f} MiB; its kernels by device ms '
                      + str({k: round(x, 4) for k, x in top}))
            del ph, sargs, kernel, plain
    return res


def default_batch(cfg, inst, dev):
    """The largest digitize batch (by photons) of ``cfg``'s run on
    ``inst`` simulated in one pass: (photon arena on the card, host piece
    table, n_samples, windows)."""
    from wfsim_tpu_torch.pipeline.rawdata import RawData
    rd = RawData(cfg, device=dev)
    rd.simulate(inst)
    _wins, arena, batches = rd.plan_digitize()
    batch, T_cap, pieces, _nix = max(
        batches, key=lambda b: int(b[2][:, :, 1].sum()))
    return arena, pieces, T_cap, len(batch)


def window_rows_measure(dev, smi, max_syncs=0):
    """Phase 3w: the arena gather and channel extents (K17,
    ``window_photons``) on the bench batch of 3j, its skewed copy (window 0
    one S2 of 10^6 photons) and the default run's largest digitize batch
    (its real arena, pieces and dropped photons): bitwise against its twin
    ``window_photons_ref`` (every output), one launch and no read-back a
    call (at most ``max_syncs``; None counts them without a limit), then
    once under ``set_sync_debug_mode('error')``; ``ms``, ``device_ms`` (the
    kernels' records) and the call's device time with its table copy,
    ``host_us`` over 1,000 calls, the twin's time, the bound (each table
    photon's channel, time and gain read once, the kept photons' time and
    gain slots written once, the piece table and the rows' outputs) and
    the library call: one stable ``torch.sort`` of the batch's row keys
    alone (window * C + channel of the kept photons in arena order).
    Returns {row: measurements}."""
    import torch
    from wfsim_tpu_torch import _build
    from wfsim_tpu_torch.config import default_config
    from wfsim_tpu_torch.interface import bench_instructions
    from wfsim_tpu_torch.models.params import build_constants
    from wfsim_tpu_torch.pipeline import digitize as dg
    cfg = default_config(seed=1234, chunk_size=100)
    const = build_constants(cfg)
    C = const.n_tpc_pmts
    batches = {}
    for shape in ('bench', 'skewed'):
        t_np, ch_np, g_np, pieces, T = superpose_arena(shape, C, 20261016)
        batches[shape] = ([torch.as_tensor(a, device=dev)
                           for a in (t_np, ch_np, g_np)], pieces, T,
                          len(pieces))
    batches['default'] = default_batch(cfg, bench_instructions(512, 2000, 300),
                                       dev)
    res = {}
    for shape, (arena, pieces, T, B) in batches.items():
        row = 'window_rows' + ('' if shape == 'bench' else f'_{shape}')
        n = int(pieces[:, :, 1].sum())
        P = pieces.shape[1]
        kernel = lambda a=arena, p=pieces, T=T: (       # noqa: E731
            dg.window_photons(const, *a, p, n_samples=T))
        plain = lambda a=arena, p=pieces, T=T: (        # noqa: E731
            dg.window_photons_ref(const, *a, p, n_samples=T))
        out, ref = kernel(), plain()
        err = max(max_diff(out[k], ref[k]) for k in ref)
        same = all(torch.equal(out[k], ref[k]) for k in ref)
        n_sync, where = count_syncs(kernel)
        # the row keys of the kept photons in arena order (the library's)
        idx = np.concatenate([np.arange(lo, lo + c) for lo, c, _o in
                              pieces.reshape(-1, 3)] + [np.zeros(0, int)])
        win = np.repeat(np.arange(B), pieces[:, :, 1].sum(axis=1))
        ch_b = arena[1][torch.as_tensor(idx, device=dev)]
        keys = (torch.as_tensor(win, device=dev) * C + ch_b)[ch_b >= 0]
        n_keep = int(keys.shape[0])
        library = lambda k=keys: torch.sort(k, stable=True)  # noqa: E731
        k_launch = _build.KERNELS['wfsim_window_rows']
        before = k_launch.launches
        kernel()
        launched = k_launch.launches - before
        print(f'[window] {row}: {B} windows, {n} photons in {P} pieces a '
              f'window at most ({n_keep} kept, largest window '
              f'{int(pieces[:, :, 1].sum(axis=1).max())}), T {T}, max|diff| '
              f'{err} (bitwise {same}), launches a call {launched}, host '
              f'syncs a call {n_sync} {where}')
        if (not same or launched != 1 or (
                max_syncs is not None and n_sync > max_syncs)):
            raise AssertionError(f'{row}: K17 differs from its twin, '
                                 f'launches {launched} times or reads back '
                                 f'{n_sync} times')
        if shape == 'bench':
            sync_free('window_photons', kernel)
        R = B * C
        n_bytes = 12 * n + 8 * n_keep + 4 * (R + 1) + 9 * R + 24 * B * P
        b_ms, b_by = bound(n_bytes)
        call_ms, split = device_ms(kernel)
        dev_ms = bounded_device_ms(row, kernel, ('window_rows',), b_ms)[0]
        m = res[row] = dict(
            err=err, ms=cuda_ms(kernel), device_ms=dev_ms,
            device_call_ms=call_ms, split=split,
            plain_ms=cuda_ms(plain, reps=5), host_us=host_us(kernel, 1000),
            bytes=n_bytes, ops32=0, ops64=0, library_ms=cuda_ms(library),
            library_call='torch.sort(row keys, stable=True)', syncs=n_sync,
            photons=n, kept=n_keep, windows=B, shape=shape)
        dev_s = ('not measured' if call_ms is None else f'{call_ms:.6f} ms '
                 + str({k[:60]: round(v, 6) for k, v in split.items()}))
        print(f'[window] {row}: {m["ms"]:.4f} ms, device {fmt_ms(dev_ms)} '
              f'(first design {PARENT_DEVICE_MS[row]} ms; the call: '
              f'{dev_s}), host {m["host_us"]:.2f} us a call, '
              f'plain twin {m["plain_ms"]:.4f} ms, library (stable sort of '
              f'{n_keep} row keys) {m["library_ms"]:.4f} ms, bound '
              f'{b_ms:.6f} ms by {b_by} ({smi})')
        del out, ref, kernel, plain, library, keys
    return res


#: the ZLE and record-pack rows' grids: the three superposition batches
#: on the slim grid (the default path's) and the bench batch on the full
#: XENONnT grid (801 rows a window, the 801-wide bank, ZLE's nonneg mode)
ZLE_PACK_GRIDS = tuple(SUPERPOSE_SHAPES) + ('full',)


def zle_pack_measure(dev, smi, max_syncs=(0, 1)):
    """Phase 3k: the ZLE interval search (K3) and the record pack (K4) on
    each grid of ZLE_PACK_GRIDS: each kernel bitwise against its twin
    (sentinel slots included), its host syncs a call (at most
    ``max_syncs``, K3's and K4's; None counts them without a limit, for
    another checkout's wrappers), ``ms``, ``device_ms``, ``host_us`` over
    1,000 calls, the twin's time and the bound.  K3's bytes: the in-window
    samples of the rows with photons, the four row inputs and its outputs;
    K4's: the samples its records read, the records and their meta, the
    row inputs and the interval slots in use.  Returns {row name:
    measurements (see make_check)}; a row off the bench batch is named
    with the grid as a suffix."""
    import torch
    from wfsim_tpu_torch.config import default_config
    from wfsim_tpu_torch.models.params import build_params, build_constants
    from wfsim_tpu_torch.ops.waveform import superpose_adc, superpose_adc_full
    from wfsim_tpu_torch.ops.zle import zle_all_channels, zle_all_channels_ref
    from wfsim_tpu_torch.pipeline.digitize import (
        full_grid_rows, pack_records, pack_records_ref, window_photons)
    from wfsim_tpu_torch.resources import load_config
    from wfsim_tpu_torch.resources.synthetic import synthetic_noise
    cfg = default_config(seed=1234, chunk_size=100, enable_noise=True,
                         enable_pmt_afterpulses=True,
                         enable_electron_afterpulses=True)
    const = build_constants(cfg)
    params = build_params(cfg, load_config(cfg), dev)
    C, K, tw = const.n_tpc_pmts, 64, const.trigger_window
    res = {}
    for grid_name in ZLE_PACK_GRIDS:
        shape = 'bench' if grid_name == 'full' else grid_name
        t_np, ch_np, g_np, pieces, T = superpose_arena(shape, C, 20261016)
        B = len(pieces)
        ph = window_photons(const, *(torch.as_tensor(a, device=dev)
                                     for a in (t_np, ch_np, g_np)),
                            pieces, n_samples=T)
        sargs = (ph['t'], ph['gain'], ph['row_ptr'], params.templates,
                 ph['ch_left'], ph['ch_right'], ph['has'])
        skw = dict(current_2_adc=const.current_2_adc,
                   baseline=const.digitizer_reference_baseline, n_samples=T)
        rows = [ph[k].reshape(B, C) for k in ('ch_left', 'ch_right', 'has')]
        if grid_name == 'full':
            R = const.n_channels_total
            bank = torch.as_tensor(np.ascontiguousarray(
                synthetic_noise(R, 100_000, seed=801).T.astype(np.int16)),
                device=dev)
            nix = torch.as_tensor(100_000 - T // 2 + np.arange(B) * 7,
                                  dtype=torch.int32, device=dev)
            grid = superpose_adc_full(
                *sargs, n_channels=C, n_channels_total=R,
                n_top=const.n_top_pmts, he_start=const.he_channel_start,
                sum_channel=const.sum_signal_channel,
                deamp=const.high_energy_deamp_int, noise_bank=bank,
                noise_ix=nix, **skw)
            rows = [full_grid_rows(x, const) for x in rows]
            del bank
        else:
            R = C
            grid = superpose_adc(*sargs, **skw).reshape(B, C, T)
        left, right, has = rows
        zargs = (grid.reshape(B * R, T),
                 params.zle_thresholds[:R].repeat(B).contiguous(),
                 *(x.reshape(-1).contiguous() for x in rows))
        zkw = dict(holdoff=2 * tw + 1, trigger_window=tw, max_intervals=K,
                   nonneg=grid_name == 'full')
        k3 = lambda a=zargs, k=zkw: zle_all_channels(*a, **k)      # noqa: E731
        p3 = lambda a=zargs, k=zkw: zle_all_channels_ref(*a, **k)  # noqa: E731
        zk, zr = k3(), p3()
        err3 = max(max_diff(a, b) for a, b in zip(zk, zr))
        pargs = (grid, left.contiguous(), zk[0].reshape(B, R, K),
                 zk[1].reshape(B, R, K), zk[2].reshape(B, R))
        k4 = lambda a=pargs: pack_records(*a)                      # noqa: E731
        p4 = lambda a=pargs: pack_records_ref(*a)                  # noqa: E731
        pk, pr = k4(), p4()
        err4 = max(max_diff(a, b) for a, b in zip(pk, pr))
        syncs = [count_syncs(f) for f in (k3, k4)]
        # the work this input needs (see the docstring)
        span = torch.clamp(torch.clamp_max(right, T - 1)
                           - torch.clamp_min(left, 0) + 1, min=0)
        n_in = int(torch.where(has, span, 0).sum())
        n_itv = torch.clamp(zk[2], 0, K)
        used = (torch.arange(K, device=dev)[None, :] < n_itv[:, None])
        plen = torch.where(used, zk[1] - zk[0] + 1, 0)
        n_read = int(torch.clamp_min(plen, 0).sum())
        n_rec = int(pk[0].shape[0])
        n_used = int(used.sum())
        works = (
            ('zle_intervals', k3, p3, err3, syncs[0],
             2 * n_in + B * R * 13 + nbytes(zk), n_in * 4),
            ('pack_records', k4, p4, err4, syncs[1],
             2 * n_read + n_rec * (110 * 2 + 6 * 4) + B * R * 8 + n_used * 8,
             n_read + n_rec * 6))
        print(f'[zle-pack] {grid_name}: {B} x {R} x {T}, in-window samples '
              f'{n_in}, intervals {int(zr[2].sum())}, records {n_rec} '
              f'({n_read} samples read), K3 max|diff| {err3}, host syncs '
              f'{syncs[0]}, K4 max|diff| {err4}, host syncs {syncs[1]}')
        for i, (name, kernel, plain, err, (n_sync, where), n_bytes,
                ops) in enumerate(works):
            row = name + ('' if grid_name == 'bench' else f'_{grid_name}')
            limit = None if max_syncs is None else max_syncs[i]
            if err or (limit is not None and n_sync > limit):
                raise AssertionError(f'{row}: the kernel differs from its '
                                     f'twin or reads back more than '
                                     f'{limit} times ({where})')
            dev_ms, by_name = device_ms(kernel)
            m = res[row] = dict(
                err=err, ms=cuda_ms(kernel), device_ms=dev_ms,
                plain_ms=cuda_ms(plain, reps=5),
                host_us=host_us(kernel, 1000), bytes=n_bytes, ops32=ops,
                ops64=0, library_ms=None, syncs=n_sync, shape=grid_name,
                records=n_rec, in_window=n_in)
            b_ms, b_by = bound(n_bytes, ops)
            dev_s = ('not measured' if dev_ms is None else f'{dev_ms:.4f} ms '
                     + str({k[:60]: round(v, 6) for k, v in by_name.items()}))
            print(f'[zle-pack] {row}: {m["ms"]:.4f} ms, device {dev_s}, '
                  f'host {m["host_us"]:.2f} us a call, plain twin '
                  f'{m["plain_ms"]:.4f} ms, bound {b_ms:.6f} ms by {b_by} '
                  f'({smi})')
        del ph, sargs, grid, zk, zr, pk, pr, zargs, pargs, k3, p3, k4, p4
        del works
    return res


def first_round(cfg, inst, dev):
    """The first digitize round of ``cfg``'s run on ``inst``: a RawData
    that simulated the first super-batch and planned its round, and the
    round's ``(window ids, rec_data, rec_meta)`` per batch, its windows'
    left edges, largest window and grid rows (``round_order``'s
    arguments)."""
    import torch
    from wfsim_tpu_torch.pipeline.digitize import (full_grid, gather_digitize,
                                                   pack_records)
    from wfsim_tpu_torch.pipeline.rawdata import RawData
    rd = RawData(cfg, device=dev)
    arrival = rd._arrival_times(inst)
    order, safe_t = rd._split_super_batches(
        arrival, np.argsort(arrival, kind='stable'))[0]
    rd.simulate(inst, order)
    wins, arena, batches = rd.plan_digitize(safe_t)
    c = rd.const
    parts = []
    for batch, T_cap, pieces, nix in batches:
        g = gather_digitize(rd.params, c, *arena, pieces,
                            torch.as_tensor(nix, device=dev),
                            n_samples=T_cap, max_intervals=64)
        parts.append((batch, *pack_records(g['data'], g['left_all'],
                                           g['starts'], g['ends'],
                                           g['counts'])))
    return rd, dict(parts=parts, win_left=[w['win_left'] for w in wins],
                    n_samples=max(b[1] for b in batches),
                    n_rows=(c.n_channels_total if full_grid(rd.params, c)
                            else c.n_tpc_pmts))


def arena_copy_measure(rows, reps=5):
    """Seconds of one round's rows from the card into the host, median of
    ``reps``, three ways: the record arena's (a fresh RecordArena: put,
    the copy into a pinned staging buffer on the copy stream, wait, the
    host copy into the base), with the host seconds of ``put`` alone (what
    stays on the host before the next super-batch); a fresh base of the
    arena's size page-locked (``cudaHostRegister``) so that the copy lands
    in it, then released; and the pageable synchronous copy
    ``dest.copy_(rows)`` into a fresh numpy array.  Each result is held to
    the rows' bytes."""
    import torch
    from wfsim_tpu_torch.pipeline.arena import RECORD_DTYPE, RecordArena
    cudart = torch.cuda.cudart()
    want = rows.cpu().numpy().tobytes()
    n = int(rows.shape[0])

    def staging():
        copy = RecordArena().put(rows)
        return copy, lambda: RecordArena.wait(copy)

    def registered():
        base = np.empty(max(n, RecordArena.chunk_rows), RECORD_DTYPE)
        if int(cudart.cudaHostRegister(base.ctypes.data, base.nbytes, 0)):
            raise RuntimeError('cudaHostRegister failed')
        dest = base[:n]
        stream = torch.cuda.Stream(rows.device)
        stream.wait_stream(torch.cuda.current_stream(rows.device))
        with torch.cuda.stream(stream):
            torch.from_numpy(dest.view(np.int16).reshape(rows.shape)).copy_(
                rows, non_blocking=True)
            event = torch.cuda.Event()
            event.record(stream)

        def finish():
            event.synchronize()
            if int(cudart.cudaHostUnregister(base.ctypes.data)):
                raise RuntimeError('cudaHostUnregister failed')
            return dest
        return None, finish

    def pageable():
        dest = np.empty(n, RECORD_DTYPE)
        torch.from_numpy(dest.view(np.int16).reshape(rows.shape)).copy_(rows)
        return None, lambda: dest
    res = {}
    for mode, start in (('staging', staging), ('registered', registered),
                        ('pageable', pageable)):
        total, put = [], []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _copy, finish = start()
            t1 = time.perf_counter()
            got = finish()
            total.append(time.perf_counter() - t0)
            put.append(t1 - t0)
            if got.view(np.int16).tobytes() != want:
                raise AssertionError(f'the round\'s copy ({mode}) differs')
            del got, finish, _copy
        res[mode] = dict(s=statistics.median(total),
                         put_s=statistics.median(put))
    return res


def record_rows_measure(dev, smi, max_syncs=0):
    """Phase 3u: the round ordering (``round_order``, csrc/round_order.cu)
    and the record rows (K4r) on the first round of the default run (its
    records from the card's K4).  The ordering: perm, win and counts
    bitwise against its plain version (``round_order_ref``: the packed
    keys and one stable ``torch.sort``, then ``searchsorted``), no
    read-back (at most ``max_syncs``; None counts them without a limit),
    ``ms``, ``device_ms``, ``host_us`` over 1,000 calls, the plain
    version's time, the bound (each record's window, start and channel
    read once, its place and window written once, the windows' counts
    and bases) and the library call: the stable sort of the packed keys
    alone.  K4r, on the batches' records where they lie (no concatenation)
    in the kernel's order: bitwise against its twin and against the
    library composition (the rows built in torch, then one
    ``index_select``: two calls), no read-back, the same times, the bound
    (each record's samples, meta, window and permutation entry read once,
    the windows' edges, 244 bytes a row written once) and
    ``round_records``' time; then the round's rows into the host three
    ways (arena_copy_measure).  Each device time is printed beside its
    parent's (PARENT_DEVICE_MS).  Returns {'round_order': ...,
    'record_rows': ...}."""
    import torch
    from wfsim_tpu_torch import _build
    from wfsim_tpu_torch.config import default_config
    from wfsim_tpu_torch.interface import bench_instructions
    from wfsim_tpu_torch.pipeline.arena import RecordArena
    from wfsim_tpu_torch.pipeline.digitize import (
        record_rows, record_rows_ref, round_order, round_order_ref,
        round_records, rows_of)
    cfg = default_config(seed=1234, chunk_size=100)
    rd, rnd = first_round(cfg, bench_instructions(512, 2000, 300), dev)
    dt = rd.const.sample_duration
    kw = dict(n_samples=rnd['n_samples'], n_rows=rnd['n_rows'])
    res = {}

    # the ordering
    order = lambda: round_order(list(rnd['parts']),  # noqa: E731
                                rnd['win_left'], **kw)
    order_ref = lambda: round_order_ref(list(rnd['parts']),  # noqa: E731
                                        rnd['win_left'], **kw)
    o, ref = order(), order_ref()
    n, n_win = int(o['perm'].shape[0]), len(rnd['win_left'])
    same = all(torch.equal(o[k], ref[k]) for k in ('perm', 'win', 'counts'))
    err = max(max_diff(o[k], ref[k]) for k in ('perm', 'win', 'counts'))
    n_sync, where = count_syncs(order)
    k_order = _build.KERNELS['wfsim_round_order']
    before = k_order.launches
    order()
    launched = k_order.launches - before
    if not same or launched != 1 or (
            max_syncs is not None and n_sync > max_syncs):
        raise AssertionError(f'round_order differs from its plain version '
                             f'({err}), launches {launched} times or reads '
                             f'back {n_sync} times ({where})')
    sync_free('round_order', order)
    key = ref['key']
    o_bytes = n * (12 + 8 + 4) + n_win * 16
    ob_ms, ob_by = bound(o_bytes)
    dev_ms, by_name = bounded_device_ms('round_order', order,
                                        ('round_count', 'round_sort'), ob_ms)
    m = res['round_order'] = dict(
        err=err, ms=cuda_ms(order), device_ms=dev_ms,
        plain_ms=cuda_ms(order_ref, reps=10), host_us=host_us(order, 1000),
        bytes=o_bytes, ops32=0, ops64=0,
        library_ms=cuda_ms(lambda: torch.sort(key, stable=True), reps=10),
        library_call='torch.sort(packed keys, stable=True)', syncs=n_sync,
        records=n, windows=n_win, split=by_name,
        max_window=int(ref['counts'].max()))
    dev_s = ('not measured' if dev_ms is None else f'{dev_ms:.6f} ms '
             + str({k[:60]: round(v, 6) for k, v in by_name.items()}))
    print(f'[rows] round_order: the default run\'s first round, {n} records '
          f'in {n_win} windows (largest {m["max_window"]}) of '
          f'{len(rnd["parts"])} batches, bitwise {same}, launches a call '
          f'{launched}, host syncs {n_sync}: {m["ms"]:.4f} ms, device {dev_s} '
          f'(parent\'s sort {PARENT_DEVICE_MS["round_order"]} ms), host '
          f'{m["host_us"]:.2f} us a call, plain version {m["plain_ms"]:.4f} '
          f'ms, library (stable sort of the packed keys) '
          f'{m["library_ms"]:.4f} ms, bound {ob_ms:.6f} ms by {ob_by} ({smi})')

    # the record rows
    args = (o['data'], o['meta'], o['win'], o['win_left'], o['perm'], dt)
    kernel = lambda: record_rows(*args)                 # noqa: E731
    plain = lambda: record_rows_ref(*args)              # noqa: E731
    data, meta = torch.cat(o['data']), torch.cat(o['meta'])
    library = lambda: rows_of(data, meta, o['win'],  # noqa: E731
                              o['win_left'], dt).index_select(0, o['perm'])
    out = kernel()
    err = max_diff(out, plain())
    lib_diff = max_diff(library(), out)
    n_sync, where = count_syncs(kernel)
    if err or lib_diff or (max_syncs is not None and n_sync > max_syncs):
        raise AssertionError(f'record_rows differs from its twin ({err}) or '
                             f'the library ({lib_diff}), or reads back '
                             f'{n_sync} times ({where})')
    n_bytes = n * (220 + 24 + 4 + 8 + 244) + n_win * 8
    b_rows = n * (220 + 24 + 244)
    dev_ms, by_name = bounded_device_ms('record_rows', kernel,
                                        ('record_rows',),
                                        bound(n_bytes)[0])
    round_ms = cuda_ms(lambda: round_records(list(rnd['parts']),
                                             rnd['win_left'], dt=dt, **kw),
                       reps=10)
    m = res['record_rows'] = dict(
        err=err, ms=cuda_ms(kernel), device_ms=dev_ms,
        plain_ms=cuda_ms(plain, reps=5), host_us=host_us(kernel, 1000),
        bytes=n_bytes, ops32=0, ops64=0,
        library_ms=cuda_ms(library, reps=10), library_diff=lib_diff,
        library_call='rows_of + index_select (two calls)',
        library_calls=2, syncs=n_sync, records=n, windows=n_win,
        sort_ms=res['round_order']['library_ms'], round_records_ms=round_ms,
        bound_rows_ms=bound(b_rows)[0], copy=arena_copy_measure(out),
        arena_base_rows=max(n, RecordArena.chunk_rows))
    del data, meta
    b_ms, b_by = bound(n_bytes)
    dev_s = ('not measured' if dev_ms is None else f'{dev_ms:.6f} ms '
             + str({k[:60]: round(v, 6) for k, v in by_name.items()}))
    print(f'[rows] record_rows: the same round, max|diff| {err} (library '
          f'{lib_diff}), host syncs {n_sync}: {m["ms"]:.4f} ms, device '
          f'{dev_s} (parent {PARENT_DEVICE_MS["record_rows"]} ms), host '
          f'{m["host_us"]:.2f} us a call, plain twin {m["plain_ms"]:.4f} ms, '
          f'library (two calls) {m["library_ms"]:.4f} ms, bound {b_ms:.6f} '
          f'ms by {b_by} (samples, meta and rows alone: '
          f'{m["bound_rows_ms"]:.6f} ms); round_records {round_ms:.4f} ms '
          f'({smi})')
    for mode, c in m['copy'].items():
        put = f', before the wait {c["put_s"]:.6f} s'
        print(f'[rows] the round\'s {n * 244 / 2 ** 20:.1f} MiB to the host, '
              f'{mode}: {c["s"]:.6f} s ({n * 244 / c["s"] / 1e9:.2f} GB/s'
              f'{put}; arena base {m["arena_base_rows"]} rows) ({smi})')
    del o, ref, rd, rnd, out, args

    # the ordering on a window of 10^5 records and on a full-grid round
    rounds = res['round_order']['rounds'] = {}
    rounds['window_1e5'] = order_round_measure(
        'a round with a window of 10^5 records', long_round(100_000, dev),
        smi)
    tmp = tempfile.mkdtemp(prefix='wfsim_3u_')
    try:
        from wfsim_tpu_torch import config as cf
        from wfsim_tpu_torch.resources import synthetic as syn
        syn.write_production_files(tmp, 1234)
        cfg = default_config(seed=1234, chunk_size=100,
                             **cf.he_full_grid_overrides(tmp))
        _rd, rnd = first_round(cfg, bench_instructions(512, 2000, 300), dev)
        rounds['he_full_grid'] = order_round_measure(
            'the he_full_grid run\'s first round', rnd, smi)
        del _rd, rnd
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return res


def long_round(n_long, dev, seed=5):
    """round_order's arguments for a round of three windows in two
    batches as K4 writes them (window by window, channel by channel,
    starts unique and increasing within a channel, T 2^17, 494 rows):
    window 1 holds ``n_long`` records or a few more, windows 0 and 2 a
    few hundred each."""
    import torch
    rng = np.random.default_rng(seed)
    T, C = 2 ** 17, 494
    per = -(-n_long // C)

    def window(n_ch, k):
        st = np.sort(np.stack([rng.choice(T, k, replace=False)
                               for _ in range(n_ch)]), axis=1).reshape(-1)
        return np.repeat(np.arange(n_ch), k), st
    rows = {0: window(100, 3), 1: window(C, per), 2: window(100, 2)}
    parts = []
    for batch in (np.array([0, 2]), np.array([1])):
        meta = np.concatenate([np.stack(
            [np.full(len(rows[int(w)][0]), bi), *rows[int(w)],
             rng.integers(1, 111, len(rows[int(w)][0])),
             rng.integers(1, 900, len(rows[int(w)][0])),
             rng.integers(0, 9, len(rows[int(w)][0]))], axis=1)
            for bi, w in enumerate(batch)]).astype(np.int32)
        data = rng.integers(-2 ** 15, 2 ** 15, (len(meta), 110),
                            dtype=np.int16)
        parts.append((batch, torch.as_tensor(data, device=dev),
                      torch.as_tensor(meta, device=dev)))
    return dict(parts=parts, win_left=[10 ** 9, 2 * 10 ** 9, 3 * 10 ** 9],
                n_samples=T, n_rows=C)


def order_round_measure(label, rnd, smi):
    """The round ordering on one more round (``rnd`` as first_round gives
    it): perm, win and counts bitwise its plain version, its device time
    and the library's (the stable sort of the packed keys alone) in the
    same process, with the round's largest window (records) and largest
    start, and the windows that take each of the kernel's paths (counting:
    at most 4,096 records whose starts lie below 4,096; coarse: the other
    windows of at most 4,096 records, their starts shifted into 4,096
    bins; chunked: longer)."""
    import torch
    from wfsim_tpu_torch.pipeline.digitize import round_order, round_order_ref
    kw = dict(n_samples=rnd['n_samples'], n_rows=rnd['n_rows'])
    order = lambda: round_order(list(rnd['parts']),  # noqa: E731
                                rnd['win_left'], **kw)
    o = order()
    ref = round_order_ref(list(rnd['parts']), rnd['win_left'], **kw)
    err = max(max_diff(o[k], ref[k]) for k in ('perm', 'win', 'counts'))
    if err:
        raise AssertionError(f'round_order differs from its plain version '
                             f'on {label} ({err})')
    n, n_win = int(o['perm'].shape[0]), len(rnd['win_left'])
    top = torch.full((n_win,), -1, dtype=torch.int64, device=o['win'].device)
    top.scatter_reduce_(0, o['win'].to(torch.int64),
                        torch.cat([m for _, _, m in rnd['parts']])[:, 2].to(
                            torch.int64), 'amax')
    cnt, top = ref['counts'].cpu().numpy(), top.cpu().numpy()
    paths = dict(counting=int(((cnt > 0) & (cnt <= 4096) & (top < 4096)).sum()),
                 coarse=int(((cnt <= 4096) & (top >= 4096)).sum()),
                 chunked=int((cnt > 4096).sum()))
    o_bytes = n * (12 + 8 + 4) + n_win * 16
    ob_ms, ob_by = bound(o_bytes)
    dev_ms, by_name = bounded_device_ms('round_order', order,
                                        ('round_count', 'round_sort'), ob_ms)
    key = ref['key']
    m = dict(records=n, windows=n_win, max_window=int(cnt.max()),
             max_start=int(top.max()), paths=paths, ms=cuda_ms(order),
             device_ms=dev_ms, bound_ms=ob_ms, bound_by=ob_by,
             library_ms=cuda_ms(lambda: torch.sort(key, stable=True),
                                reps=10))
    dev_s = ('not measured' if dev_ms is None else f'{dev_ms:.6f} ms '
             + str({k[:60]: round(v, 6) for k, v in by_name.items()}))
    print(f'[rows] round_order on {label}: {n} records in {n_win} windows '
          f'(largest {m["max_window"]} records, largest start '
          f'{m["max_start"]}; windows by path {paths}), bitwise the plain '
          f'version: {m["ms"]:.4f} ms, device {dev_s}, library (stable sort '
          f'of the packed keys) {m["library_ms"]:.4f} ms, bound '
          f'{ob_ms:.6f} ms by {ob_by} ({smi})')
    return m


def round_windows(stats):
    """Wrap the pipeline's round_records so that each round's batch
    windows' record counts and largest starts are appended to ``stats``
    (one read-back a batch: for a warm-up run, never a timed one);
    returns a function that restores it."""
    import torch
    from wfsim_tpu_torch.pipeline import rawdata
    orig = rawdata.round_records

    def wrapped(parts, win_left, **kw):
        for batch, _d, m in parts:
            idx = m[:, 0].to(torch.int64)
            top = torch.full((len(batch),), -1, dtype=torch.int32,
                             device=m.device)
            top.scatter_reduce_(0, idx, m[:, 2], 'amax')
            stats.append((torch.bincount(idx, minlength=len(batch)).cpu()
                          .numpy(), top.cpu().numpy()))
        return orig(parts, win_left, **kw)
    rawdata.round_records = wrapped

    def restore():
        rawdata.round_records = orig
    return restore


def window_summary(stats):
    """Windows, the largest window's records, the largest start and the
    windows of each path of round_order.cu (as order_round_measure) over
    a run's ``round_windows`` stats."""
    cnt = np.concatenate([c for c, _ in stats] or [np.zeros(0, np.int64)])
    top = np.concatenate([t for _, t in stats] or [np.zeros(0, np.int32)])
    return dict(windows=len(cnt), max_window=int(cnt.max(initial=0)),
                max_start=int(top.max(initial=-1)),
                counting=int(((cnt > 0) & (cnt <= 4096) & (top < 4096)).sum()),
                coarse=int(((cnt <= 4096) & (top >= 4096)).sum()),
                chunked=int((cnt > 4096).sum()))


#: the ten configurations of a 512-event run (PERF.md §4), in the order
#: config_runs takes them
RUN_CONFIGS = ('default', 'realistic', 'detector_physics', 'he_full_grid',
               'timing_models', 'per_pmt_truth', 'xenon1t_full_grid',
               'field_maps', 'optical_nveto', 'optical_tpc')


def config_run(name, dev, tmp):
    """A callable that runs configuration ``name`` (RUN_CONFIGS; its files
    written into ``tmp``) once on its 512-event workload through the entry
    a user calls, and returns (records per output, the raw data's
    Timers summary)."""
    from wfsim_tpu_torch import Simulator, default_config
    from wfsim_tpu_torch import config as cf
    from wfsim_tpu_torch import interface as itf
    from wfsim_tpu_torch.resources import synthetic as syn
    inst = itf.bench_instructions(512, 2000, 300)
    realism = dict(enable_noise=True, enable_pmt_afterpulses=True,
                   enable_electron_afterpulses=True)
    if name.startswith('optical_'):
        from wfsim_tpu_torch.pipeline.chunker import ChunkRawRecords
        from wfsim_tpu_torch.pipeline.optical import RawDataOptical
        cfg, ins, ch, t, _t_read = optical_inputs(name)

        def run():
            sim = ChunkRawRecords(cfg, device=dev,
                                  rawdata_generator=RawDataOptical,
                                  channels=ch, timings=t)
            n = sum(len(o['raw_records']) for o in sim(ins))
            return (n,), sim.rawdata.diag.summary()
        return run
    if name == 'detector_physics':
        over = cf.detector_physics_overrides(syn.write_pattern_map(
            Path(tmp) / 's2_pattern_map.json', 1234))
    elif name == 'he_full_grid':
        syn.write_production_files(tmp, 1234)
        over = cf.he_full_grid_overrides(tmp)
    elif name == 'timing_models':
        over = cf.timing_models_overrides(syn.write_garfield_table(
            Path(tmp) / 'garfield.npz', 1234))
    elif name == 'field_maps':
        syn.write_field_maps(tmp, 1234)
        over = cf.field_maps_overrides(tmp)
    else:
        over = dict(default={}, realistic=realism,
                    per_pmt_truth=dict(per_pmt_truth=True, **realism),
                    xenon1t_full_grid=dict(
                        detector='XENON1T',
                        high_energy_deamplification_factor=1.0,
                        per_pmt_truth=True, **realism))[name]
    cfg = default_config(seed=1234, chunk_size=100, **over)
    if name == 'detector_physics':
        inst = itf.detector_physics_instructions(512, 2000, 300)
    elif name == 'timing_models':
        inst = itf.timing_models_instructions(512, 2000, 300)

    def run():
        sim = Simulator(cfg, device=dev)
        out = sim.get_arrays(inst)
        n = tuple(len(out[k]) for k in ('raw_records', 'raw_records_he')
                  if k in out and (k == 'raw_records' or len(out[k])))
        return n, sim.sim.rawdata.diag.summary()
    return run


def config_runs(dev, smi, names=RUN_CONFIGS):
    """Each configuration of ``names``: a warm-up run, then a timed one
    with the peak device memory reset before it; returns {name: wall_s,
    ev_s, records, the Timers, peak device MiB, VmRSS MiB after the run
    (its arrays dropped)}."""
    import torch
    res = {}
    tmp = tempfile.mkdtemp(prefix='wfsim_runs_')
    try:
        for name in names:
            run = config_run(name, dev, tmp)
            stats = []
            restore = round_windows(stats)
            try:
                run()                                       # warm-up
            finally:
                restore()
            wsum = window_summary(stats)
            print(f'[windows] {name}: round windows {wsum} ({smi})')
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            t0 = time.perf_counter()
            records, diag = run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            res[name] = dict(wall_s=wall, ev_s=512 / wall, records=records,
                             peak_mib=torch.cuda.max_memory_allocated(dev)
                             / 2 ** 20, rss_mib=rss_mib(), timers=diag,
                             round_windows=wsum)
            print(f'[runs] {name}: {json.dumps(res[name])} ({smi})')
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return res


#: phase 3l's batches: K11 on the 3b shape (1.5 M S2-like photons over 512
#: truth rows, the realistic tables) and a skewed copy whose truth row 100
#: holds 10^6 of them; K12b on the detector_physics S2 batch of the bench
#: instructions and a skewed copy whose instruction 100 has 10^5 electrons
AP_SHAPE = (1_500_000, 512)
AP_SKEWED_ROW = (100, 1_000_000)
DIFFUSE_SKEWED_INST = (100, 100_000)


def ap_batch(params, const, skewed, dev, seed):
    """(photons, draws) of one K11 batch of phase 3l (see AP_SHAPE)."""
    import torch
    from wfsim_tpu_torch.models.afterpulse import pmt_ap_draws
    n, n_rows = AP_SHAPE
    rng = np.random.default_rng(seed)
    ph = s2_like_photons(rng, n, int(params.gains.shape[0]), n_rows, dev)
    if skewed:
        row, big = AP_SKEWED_ROW
        ph['truth_row'] = torch.as_tensor(np.sort(np.concatenate(
            [np.full(big, row), rng.integers(0, n_rows, n - big)])),
            device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return ph, pmt_ap_draws(gen, int(params.pmt_ap_delay_cdf.shape[0]), n,
                            dev)


def ap_work(params, const, ph, draws, out, info, n_rows):
    """(bytes, old bytes, float32 operations, the draws' bytes) of one K11
    call.  Bytes: the 32-byte sectors of the (E, n) draws that select and
    emit read (u0 where the photon is valid; u2 for a non-uniform element
    where a valid slot passes the delay test and the element's amplitude
    bin is positive, select's test order; u1 for a uniform element where a
    slot is selected, which emit reads); per photon ch, is_dpe and valid;
    per selected slot its t and truth row, the table entries its
    inversions end on (a uniform element's two delay values, another's two
    delay and two amplitude values) and its gain, and its outputs (t, ch,
    gain, is_dpe, valid, truth row); per (element, channel) the three table
    values select compares; per row the counts, t_min and t_max.  The old
    count took every uniform, every photon field, the whole tables and
    the outputs."""
    import torch
    from wfsim_tpu_torch.models.afterpulse import _meta, _select_ref, \
        _uniforms
    delay = params.pmt_ap_delay_cdf
    E, C, _Td = delay.shape
    n = int(ph['t'].shape[0])
    uni_t, _dbin, abin = _meta(const, ph['t'].device)
    chc = torch.clamp(ph['ch'], 0, C - 1).to(torch.int64)
    r0, _aux = _uniforms(const, draws, uni_t, ph['is_dpe'])
    valid = ph['valid'][None, :].expand(E, n)
    delay_ok = valid & (r0 <= delay[:, :, -1][:, chc])
    sel = _select_ref(params, const, ph, draws)

    def sectors(mask):               # 32-byte sectors of an (E, n) float32
        flat = mask.reshape(-1)
        flat = torch.cat([flat, flat.new_zeros((-flat.numel()) % 8)])
        return int(flat.reshape(-1, 8).any(dim=1).sum()) * 32

    draw_bytes = (sectors(valid)
                  + sectors(delay_ok & (~uni_t & (abin > 0))[:, None])
                  + sectors(sel & uni_t[:, None]))
    uni = np.asarray(const.pmt_ap_element_uniform)
    per_e = sel.sum(1).cpu().numpy()
    total = int(per_e.sum())
    n_bytes = (draw_bytes + n * 6 + total * (4 + 8 + 4 + 22)
               + int(per_e[uni].sum()) * 8 + int(per_e[~uni].sum()) * 16
               + E * C * 12 + n_rows * 12)
    old = nbytes(ph, draws, params.pmt_ap_delay_cdf, params.pmt_ap_amp_cdf,
                 out, info)
    return n_bytes, old, E * n * 6, draw_bytes


def diffuse_batch(dev, tmp):
    """The pattern_diffuse arguments of the detector_physics S2 batch of
    the bench instructions (simple S1 timing, so no NEST tables are built:
    the S2 draws are the configuration's) and of its skewed copy (see
    DIFFUSE_SKEWED_INST), as {name: (args, keyword args)}: the keyword is
    the chunk count ``n_split``, as the S2 pass passes it, where the
    checkout's pattern_diffuse takes one (an older checkout's does not)."""
    import inspect
    import torch
    from wfsim_tpu_torch.config import default_config, \
        detector_physics_overrides
    from wfsim_tpu_torch.interface import detector_physics_instructions
    from wfsim_tpu_torch.models import s2
    from wfsim_tpu_torch.resources.synthetic import write_pattern_map
    map_path = write_pattern_map(Path(tmp) / 's2_pattern_map.json', 1234)
    cfg = default_config(seed=1234, chunk_size=100, **dict(
        detector_physics_overrides(map_path), s1_model_type='simple'))
    params, const, batches = physics_batches(
        cfg, detector_physics_instructions(512, 2000, 300), dev, 20261016)
    x2, _n_rows, d2 = batches['s2']
    e_edges = s2.s2_edges(d2)[0]
    z, xy = s2.s2_positions(params, const, x2)
    head = (params.s2_pattern, xy[:, 0].contiguous(), xy[:, 1].contiguous(),
            *s2.diffusion_inputs(params, const, z, xy), const.tpc_radius ** 2)
    C = int(params.gains.shape[0])
    counts = (e_edges[1:] - e_edges[:-1]).cpu().numpy().copy()
    inst, big = DIFFUSE_SKEWED_INST
    counts[inst] = big
    n_sk = int(counts.sum())
    rng = np.random.default_rng(20261016)
    normals = [torch.as_tensor(rng.standard_normal(n_sk, dtype=np.float32),
                               device=dev) for _ in range(2)]
    edges_sk = torch.as_tensor(np.concatenate([[0], np.cumsum(counts)]),
                               device=dev)
    takes = 'n_split' in inspect.signature(s2.pattern_diffuse).parameters
    split = {}
    if takes:
        split = {'pattern_diffuse': dict(n_split=d2['diff_split']),
                 'pattern_diffuse_skewed': dict(n_split=int(
                     (np.maximum(counts - 1, 0) // s2.DIFFUSE_CHUNK).sum()))}
    return {'pattern_diffuse': ((*head, e_edges, d2['diff_r'], d2['diff_a'],
                                 C), split.get('pattern_diffuse', {})),
            'pattern_diffuse_skewed': ((*head, edges_sk, *normals, C),
                                       split.get('pattern_diffuse_skewed',
                                                 {}))}


def ap_diffuse_measure(dev, smi, max_syncs=(1, 0)):
    """Phase 3l: the PMT-afterpulse generator (K11 select + emit) on the 3b
    shape and its skewed copy, the diffused pattern (K12b) on the
    detector_physics S2 batch and its skewed copy (AP_SHAPE, AP_SKEWED_ROW,
    DIFFUSE_SKEWED_INST): each bitwise against its twin, its host syncs a
    call (at most ``max_syncs``, K11's and K12b's; None counts them without
    a limit, for another checkout's wrappers), ``ms``, ``device_ms`` split
    by kernel, ``host_us`` over 1,000 calls, the twin's time and the bound
    (K11's bytes by ap_work, both counts printed; K12b's the operations of
    phase 3d).  Returns {row name: measurements (see make_check)}."""
    import torch
    from wfsim_tpu_torch.config import default_config
    from wfsim_tpu_torch.models import s2
    from wfsim_tpu_torch.models.afterpulse import (
        pmt_afterpulse_photons, pmt_afterpulse_photons_ref)
    from wfsim_tpu_torch.models.params import build_params, build_constants
    from wfsim_tpu_torch.resources import load_config
    cfg = default_config(seed=1234, chunk_size=100, enable_noise=True,
                         enable_pmt_afterpulses=True,
                         enable_electron_afterpulses=True)
    params = build_params(cfg, load_config(cfg), dev)
    const = build_constants(cfg)
    n_rows = AP_SHAPE[1]
    works = []

    def ap_call(fn, ph, draws):
        def call():
            out, info = fn(params, const, ph, draws, n_truth_rows=n_rows)
            return (*out.values(), info['counts'], info['t_min'],
                    info['t_max'], torch.tensor([info['total']]))
        return call

    for skewed in (False, True):
        ph, draws = ap_batch(params, const, skewed, dev, 20261016 + skewed)
        out, info = pmt_afterpulse_photons_ref(params, const, ph, draws,
                                               n_truth_rows=n_rows)
        n_bytes, old, ops, draw_bytes = ap_work(params, const, ph, draws,
                                                out, info, n_rows)
        rows = ph['truth_row']
        print(f'[ap-diffuse] pmt_afterpulse{"_skewed" * skewed}: '
              f'{AP_SHAPE[0]} photons, {int(draws["u0"].shape[0])} elements,'
              f' {n_rows} rows (largest {int(torch.bincount(rows).max())}),'
              f' selected {info["total"]}; bytes {n_bytes} (the draws\' '
              f'{draw_bytes}; bound {bound(n_bytes, ops)[0]:.6f} ms; the '
              f'old count {old}: bound {bound(old, ops)[0]:.6f} ms)')
        works.append(('pmt_afterpulse' + '_skewed' * skewed,
                      ap_call(pmt_afterpulse_photons, ph, draws),
                      ap_call(pmt_afterpulse_photons_ref, ph, draws),
                      0 if max_syncs is None else max_syncs[0], n_bytes,
                      ops, 0))
    tmp = tempfile.mkdtemp(prefix='wfsim_smoke_')
    try:
        for name, (args, kw) in diffuse_batch(dev, tmp).items():
            n_e, C = int(args[-2].shape[0]), args[-1]
            counts = args[-4][1:] - args[-4][:-1]
            print(f'[ap-diffuse] {name}: {int(args[1].shape[0])} '
                  f'instructions, {n_e} electrons (largest '
                  f'{int(counts.max())}), {C} channels, map '
                  f'{tuple(args[0].values.shape)}, chunk count {kw}')
            works.append((name, lambda a=args, k=kw: (
                              s2.pattern_diffuse(*a, **k),),
                          lambda a=args: (s2.pattern_diffuse_ref(*a),),
                          0 if max_syncs is None else max_syncs[1],
                          nbytes(args, torch.empty((int(args[1].shape[0]), C),
                                                   dtype=torch.float32)),
                          n_e * (40 + C * 8), n_e * C))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    res = {}
    for name, kernel, plain, limit, n_bytes, ops32, ops64 in works:
        err = compare(kernel(), plain(), name)
        n_sync, where = count_syncs(kernel)
        if max_syncs is not None and n_sync > limit:
            raise AssertionError(f'{name}: {n_sync} read-backs a call, more '
                                 f'than {limit} ({where})')
        dev_ms, by_name = device_ms(kernel)
        m = res[name] = dict(
            err=err, ms=cuda_ms(kernel), device_ms=dev_ms,
            plain_ms=cuda_ms(plain, reps=5), host_us=host_us(kernel, 1000),
            bytes=n_bytes, ops32=ops32, ops64=ops64, library_ms=None,
            syncs=n_sync, split={k[:60]: v for k, v in by_name.items()})
        b_ms, b_by = bound(n_bytes, ops32, ops64)
        dev_s = ('not measured' if dev_ms is None else f'{dev_ms:.4f} ms '
                 + str({k: round(v, 6) for k, v in m['split'].items()}))
        print(f'[ap-diffuse] {name}: max|diff| {err}, read-backs {n_sync} '
              f'{where}, {m["ms"]:.4f} ms, device {dev_s}, host '
              f'{m["host_us"]:.2f} us a call, plain twin '
              f'{m["plain_ms"]:.4f} ms, bound {b_ms:.6f} ms by {b_by} '
              f'({smi})')
    return res


#: phase 3m's batches: K6 on LUMI_ROWS rows of the default gas gap (the 3c
#: S2 batch's tables), of gaps uniform between the wire and the gate, and
#: of the default gap at LUMI_SEQUENTIAL_BAR, a pressure whose light-yield
#: offset lies two float32 ulps from E0 / r at r = 0.01996 cm, so that the
#: light-weighted sum fails the kernel's exactness test on every row
#: (tests/test_torch_lumi_summaries_redesign.py's SEQUENTIAL_PRESSURE_BAR);
#: the summaries on the 3b shape and its skewed copy (AP_SHAPE,
#: AP_SKEWED_ROW)
LUMI_ROWS = 512
LUMI_SEQUENTIAL_BAR = 22.70032


def lumi_calls(s2, const, n, dev, dG):
    """(kernel call, twin call) of a checkout's luminescence tables on the
    gas gaps ``dG`` (None: the constant gap).  A checkout whose wrapper
    takes no gaps gets them through its ``_anode_field``, with E0 by the
    same float32 steps (its kernel has always read a gap and a field per
    row)."""
    import inspect
    import torch
    if dG is None or 'dG' in inspect.signature(
            s2.luminescence_tables).parameters:
        kw = {} if dG is None else dict(dG=dG)
        return (lambda: (s2.luminescence_tables(const, n, dev, **kw),),
                lambda: (s2.luminescence_tables_ref(const, n, dev, **kw),))
    rA, rW = const.anode_field_domination_distance, const.anode_wire_radius

    def div(x):
        return torch.full((), x, dtype=torch.float32, device=dG.device)
    VG = const.anode_voltage / (1 + (const.gate_to_anode_distance - dG)
                                / dG / div(const.lxe_dielectric_constant))
    E0 = VG / ((dG - rA) / div(rA) + np.log(rA / rW))
    field = s2._anode_field

    def with_gaps(fn):
        def call():
            s2._anode_field = lambda c, m, d: (dG, E0, field(c, m, d)[2])
            try:
                return (fn(const, n, dev),)
            finally:
                s2._anode_field = field
        return call
    return (with_gaps(s2.luminescence_tables),
            with_gaps(s2.luminescence_tables_ref))


def lumi_work(const, n, dG):
    """(bytes, float32 and float64 operations, and the old count's) of one
    K6 call:
    the radius, reciprocal and quantile grids, the gaps and fields where
    given, and the (n, Q) output; the twin's arithmetic on the points
    inside each row's gap (8 float32 operations and 4 float64 a point)
    and Q searches and lerps a row.  The old count took every point."""
    from wfsim_tpu_torch.models.s2 import Q
    r = np.arange(const.gate_to_anode_distance, const.anode_wire_radius,
                  -1e-4, dtype=np.float32)
    gaps = (np.full(n, np.float32(const.elr_gas_gap_length)) if dG is None
            else dG.cpu().numpy())
    R, in_gap = len(r), int((r[None, :] <= gaps[:, None]).sum())
    n_bytes = 8 * R + 4 * Q + (0 if dG is None else 8 * n) + 4 * n * Q
    search = n * Q * (int(np.ceil(np.log2(R))) + 6)
    return (n_bytes, in_gap * 8 + search, in_gap * 4, n * R * 8 + search,
            n * R * 4)


def summary_work(ph, u, counts, out):
    """(bytes, old bytes, float32 operations) of one summaries call: the
    valid flags, a 32-byte sector of truth rows at each row boundary, the
    sectors of t the candidates read, u and the outputs.  The old count
    took every photon field."""
    n = int(ph['t'].shape[0])
    n_inst, K = u.shape
    c = counts.cpu().numpy().astype(np.int64)
    off = np.cumsum(c) - c
    slot = np.clip(off[:, None] + (u.cpu().numpy() * np.maximum(c, 1)[
        :, None].astype(np.float32)).astype(np.int32), 0, n - 1)
    sectors = len(np.unique(slot // 8)) * 32
    n_bytes = n + (n_inst + 1) * 32 + sectors + nbytes(u, counts, out)
    return n_bytes, nbytes(ph, u, counts, out), n + 2 * n_inst * K


def lumi_summaries_measure(dev, smi, max_syncs=(0, 0)):
    """Phase 3m: the luminescence tables (K6) on LUMI_ROWS rows of the
    default gas gap, of gaps over the anode gap and of the constants that
    fail the kernel's exactness test (see LUMI_SEQUENTIAL_BAR), and the
    photon summaries on the 3b shape and its skewed copy: each bitwise
    against its twin, its host syncs a call (at most ``max_syncs``, K6's
    and the summaries'; None counts them without a limit, for another
    checkout's wrappers), K6's rows on its sequential pass in one call
    (held to the twin ``lumi_sequential_rows_ref``; None where the
    checkout has no count), ``ms``, ``device_ms`` split by kernel,
    ``host_us`` over 1,000 calls, the twin's time and the bound (old and
    new counts printed).  The sequential count is zeroed at the end.
    Returns {row name: measurements (see make_check)}."""
    import dataclasses
    import torch
    from wfsim_tpu_torch import units
    from wfsim_tpu_torch.config import default_config
    from wfsim_tpu_torch.models import s2
    from wfsim_tpu_torch.models.afterpulse import (
        photon_summaries, photon_summaries_ref, summary_draws)
    from wfsim_tpu_torch.models.params import build_constants
    const = build_constants(default_config(seed=1234, chunk_size=100))
    rng = np.random.default_rng(20261017)
    gaps = torch.as_tensor(rng.uniform(
        const.anode_wire_radius, const.gate_to_anode_distance,
        LUMI_ROWS).astype(np.float32), device=dev)
    count = getattr(s2, 'lumi_sequential_rows', None)
    works = []
    for name, k, dG in (
            ('lumi_tables', const, None), ('lumi_tables_gaps', const, gaps),
            ('lumi_tables_sequential', dataclasses.replace(
                const, pressure=LUMI_SEQUENTIAL_BAR * units.bar), None)):
        kernel, plain = lumi_calls(s2, k, LUMI_ROWS, dev, dG)
        n_bytes, ops32, ops64, old32, old64 = lumi_work(k, LUMI_ROWS, dG)
        want = None
        if count is not None:
            want = int(s2.lumi_sequential_rows_ref(k, LUMI_ROWS, dev,
                                                   dG).sum())
        print(f'[lumi-summ] {name}: {LUMI_ROWS} rows, sequential rows by '
              f'the twin {want}; bytes {n_bytes}, operations {ops32} '
              f'float32 + {ops64} float64 (bound '
              f'{bound(n_bytes, ops32, ops64)[0]:.6f} ms; the old count '
              f'{old32} + {old64}: {bound(n_bytes, old32, old64)[0]:.6f} '
              f'ms)')
        works.append((name, kernel, plain, 0 if max_syncs is None
                      else max_syncs[0], n_bytes, ops32, ops64, want))
    n_rows = AP_SHAPE[1]
    for skewed in (False, True):
        name = 'ap_photon_summaries' + '_skewed' * skewed
        seed = 20261016 + skewed
        rng = np.random.default_rng(seed)
        ph = s2_like_photons(rng, AP_SHAPE[0], 494, n_rows, dev)
        if skewed:
            row, big = AP_SKEWED_ROW
            ph['truth_row'] = torch.as_tensor(np.sort(np.concatenate(
                [np.full(big, row), rng.integers(0, n_rows,
                                                 AP_SHAPE[0] - big)])),
                device=dev)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        u = summary_draws(gen, n_rows, dev)
        counts, out = photon_summaries_ref(ph, u, n_inst=n_rows)
        n_bytes, old, ops32 = summary_work(ph, u, counts, out)
        print(f'[lumi-summ] {name}: {AP_SHAPE[0]} photons, {n_rows} rows '
              f'(largest {int(counts.max())}), {u.shape[1]} candidates; '
              f'bytes {n_bytes} (bound {bound(n_bytes, ops32)[0]:.6f} ms; '
              f'the old count {old}: {bound(old, ops32)[0]:.6f} ms)')
        works.append((name, lambda a=(ph, u): photon_summaries(
                          *a, n_inst=n_rows),
                      lambda a=(ph, u): photon_summaries_ref(
                          *a, n_inst=n_rows),
                      0 if max_syncs is None else max_syncs[1], n_bytes,
                      ops32, 0, None))
    res = {}
    for name, kernel, plain, limit, n_bytes, ops32, ops64, want in works:
        err = compare(kernel(), plain(), name)
        seq = None
        if count is not None and name.startswith('lumi'):
            count(dev).zero_()
            kernel()
            seq = int(count(dev))
            if seq != want:
                raise AssertionError(f'{name}: {seq} rows on the '
                                     f'sequential pass, the twin {want}')
        n_sync, where = count_syncs(kernel)
        if max_syncs is not None and n_sync > limit:
            raise AssertionError(f'{name}: {n_sync} read-backs a call, more '
                                 f'than {limit} ({where})')
        dev_ms, by_name = device_ms(kernel)
        split = {}
        for k, v in by_name.items():            # names cut to 60 characters
            split[k[:60]] = split.get(k[:60], 0.0) + v
        m = res[name] = dict(
            err=err, ms=cuda_ms(kernel), device_ms=dev_ms,
            plain_ms=cuda_ms(plain, reps=5), host_us=host_us(kernel, 1000),
            bytes=n_bytes, ops32=ops32, ops64=ops64, library_ms=None,
            syncs=n_sync, seq_rows=seq, split=split)
        b_ms, b_by = bound(n_bytes, ops32, ops64)
        dev_s = ('not measured' if dev_ms is None else f'{dev_ms:.4f} ms '
                 + str({k: round(v, 6) for k, v in m['split'].items()}))
        print(f'[lumi-summ] {name}: max|diff| {err}, read-backs {n_sync} '
              f'{where}, sequential rows {seq}, {m["ms"]:.4f} ms, device '
              f'{dev_s}, host {m["host_us"]:.2f} us a call, plain twin '
              f'{m["plain_ms"]:.4f} ms, bound {b_ms:.6f} ms by {b_by} '
              f'({smi})')
    if count is not None:
        count(dev).zero_()
    return res


#: phase 3n's skewed copy: truth row 100 of the S2 batch holds 10^6
#: photons, the other rows the remaining photons in equal parts, every row
#: with the times of one S2 (a drift-like spread)
TRUTH_SKEWED_ROW = (100, 1_000_000)


def truth_inputs(cfg, inst, dev, seed):
    """(params, const, inputs) of the truth kernels on the 512 S1 and 512
    S2 instructions of ``inst`` (physics_batches' draws): {'s1': (ph,
    row_edges), 's2': (ph, row_edges), 'electrons': (t, truth_row,
    row_edges)}, recorded from s1_photon_pass and s2_photon_pass (their
    pmt_response and photon_time_stats calls; ph is the photon pass's
    output, what the row kernel reads)."""
    from wfsim_tpu_torch.models import pmt, s1, s2
    params, const, batches = physics_batches(cfg, inst, dev, seed)
    got = {}

    def response(kind):
        def call(prm, cst, t, ch, valid, truth_row, draws, *, n_truth_rows,
                 row_edges):
            got[kind] = (pmt._photon_pass(prm, cst, t, ch, valid, truth_row,
                                          draws), row_edges)
            return pmt.pmt_response(prm, cst, t, ch, valid, truth_row, draws,
                                    n_truth_rows=n_truth_rows,
                                    row_edges=row_edges)
        return call

    def stats(t, valid, truth_row, n_truth_rows, row_edges):
        got['electrons'] = (t, truth_row, row_edges)
        return pmt.photon_time_stats(t, valid, truth_row, n_truth_rows,
                                     row_edges)
    saved = s1.pmt_response, s2.pmt_response, s2.photon_time_stats
    s1.pmt_response, s2.pmt_response = response('s1'), response('s2')
    s2.photon_time_stats = stats
    try:
        for kind, fn in (('s1', s1.s1_photon_pass),
                         ('s2', s2.s2_photon_pass)):
            x, n_rows, d = batches[kind]
            fn(params, const, x, d, n_truth_rows=n_rows)
    finally:
        s1.pmt_response, s2.pmt_response, s2.photon_time_stats = saved
    return params, const, got


def skewed_truth_copy(ph, row_edges, seed):
    """A copy of the S2 photons ``ph`` whose truth row TRUTH_SKEWED_ROW[0]
    holds TRUTH_SKEWED_ROW[1] of them and the other rows the rest in equal
    parts (row edges and truth rows rebuilt), each row with the times of
    one S2: the first time of the same row in ``ph`` + normal(0, 1.5 us) +
    exponential(140 ns).  (Rows that straddle two S2s 4 ms apart would make
    the twin's global float64 cumsum of squared offsets inexact.)"""
    import torch
    dev = ph['t'].device
    n, R = int(ph['t'].shape[0]), int(row_edges.shape[0]) - 1
    row, big = TRUTH_SKEWED_ROW
    rest = np.full(R - 1, (n - big) // (R - 1))
    rest[:(n - big) - int(rest.sum())] += 1
    lengths = np.insert(rest, row, big)
    edges = np.concatenate([[0], np.cumsum(lengths)])
    rng = np.random.default_rng(seed)
    t0 = ph['t'].cpu().numpy()[np.minimum(row_edges[:-1].cpu().numpy(),
                                          n - 1)]
    t = (np.repeat(t0.astype(np.float64), lengths) + rng.normal(0, 1500, n)
         + rng.exponential(140, n)).astype(np.int32)
    out = dict(ph, t=torch.as_tensor(t, device=dev),
               truth_row=torch.as_tensor(np.repeat(np.arange(R), lengths),
                                         device=dev))
    return out, torch.as_tensor(edges, device=dev)


def row_truth_library(params, const, ph, row_edges):
    """K8 row truth in PyTorch around ``torch.segment_reduce``: the twin's
    terms (``_truth_terms``; without ``params`` the time statistics
    alone), the twelve sums as one 'sum' over the stacked float64 terms,
    t_min and t_max as 'amin' / 'amax' of the valid times (identities as
    initial values), the min-centred moments as another 'sum', in place of
    the twin's cumsum differences.  Only the row lengths are computed
    outside the returned call."""
    import torch
    from wfsim_tpu_torch.models.pmt import TRUTH_SUMS, _truth_terms
    lo, hi = int(row_edges[0]), int(row_edges[-1])
    lengths = row_edges[1:] - row_edges[:-1]
    big = float(2 ** 31 - 1)

    def call():
        t = ph['t'][lo:hi].to(torch.float64)
        v = (torch.ones_like(t, dtype=torch.bool) if ph.get('valid') is None
             else ph['valid'][lo:hi])
        out = {}
        if params is not None:
            terms, _chc, bot = _truth_terms(params, const, ph)
            x = torch.stack([*terms, *(w * bot for w in terms)],
                            dim=1)[lo:hi].to(torch.float64)
            sums = torch.segment_reduce(x, 'sum', lengths=lengths, axis=0)
            out = {k: sums[:, i].contiguous()
                   for i, k in enumerate(TRUTH_SUMS)}
            cnt = sums[:, 0]
        else:
            cnt = torch.segment_reduce(v.to(torch.float64), 'sum',
                                       lengths=lengths)
        tmin = torch.segment_reduce(torch.where(v, t, big), 'amin',
                                    lengths=lengths, initial=big)
        tmax = torch.segment_reduce(torch.where(v, t, -big), 'amax',
                                    lengths=lengths, initial=-big)
        base = torch.repeat_interleave(torch.where(cnt > 0, tmin, 0.0),
                                       lengths, output_size=hi - lo)
        c = torch.where(v, t - base, 0.0)
        mom = torch.segment_reduce(torch.stack([c, c * c], dim=1), 'sum',
                                   lengths=lengths, axis=0)
        cntf = torch.clamp_min(cnt, 1.0)
        mean = mom[:, 0] / cntf
        var = torch.clamp_min(mom[:, 1] / cntf - mean * mean, 0.0)
        out.update(count=cnt.to(torch.int64), t_min=tmin.to(torch.int32),
                   t_max=tmax.to(torch.int32), t_mean_offset=mean,
                   t_sigma=torch.sqrt(var))
        return out
    return call


def truth_work(ph, row_edges, out, params):
    """(bytes, float32 operations) of one truth-kernel call: the photon
    fields it reads once (t; with ``params`` also valid, ch, gain, is_dpe,
    the channel table and the pulse peaks), the row edges and its outputs;
    eight float32 operations a valid photon with ``params`` (the trigger
    test and the area term; the sums are integer adds)."""
    if params is None:
        return nbytes(ph['t'], row_edges, out), 0
    return (nbytes(*(ph[k] for k in ('t', 'valid', 'ch', 'gain', 'is_dpe')),
                   row_edges, out, params.chan_pack, params.current_max),
            8 * int(ph['valid'].sum()))


#: (block_rows, chunk) of the row kernel that pmt_truth_layouts_measure
#: tries on the S2 photons, and the per-PMT kernel's chunks
ROW_TRUTH_LAYOUTS = ((True, 8192), (True, 4096), (True, 2048), (False, 1024),
                     (False, 512))
PER_PMT_CHUNKS = (2048, 4096, 8192)


def pmt_truth_measure(dev, smi, max_syncs=(0, 0)):
    """Phase 3n: the row kernel (K8 row truth) on the default run's S1
    batch, its S2 electron times (no channels), its S2 photons and a
    skewed copy (TRUTH_SKEWED_ROW), and the per-PMT kernel (K16) on that
    S2 batch (494 channels), the XENON1T one (248) and the skewed copy:
    each held against its twin (counts bitwise, FLOAT_TRUTH and the
    per-PMT areas within rtol 1e-12), the same bits on a second call, its
    host syncs a call (at most ``max_syncs``, K8's and K16's; None counts
    without a limit, for another checkout's wrappers), its rows on the
    float64 second pass in one call (held to ``row_truth_second_pass_ref``;
    None where the checkout has no count), ``ms``, ``device_ms`` split by
    kernel, ``host_us`` over 1,000 calls, the twin's time, the bound and a
    library computation (``row_truth_library``, ``per_pmt_library``) held
    against the twin too.  The second-pass counts are zeroed at the end,
    and the scratch buffers are checked to be zero (every launch leaves
    them so).  Returns {row name: measurements (see make_check)}."""
    import torch
    from wfsim_tpu_torch.config import default_config
    from wfsim_tpu_torch.interface import bench_instructions
    from wfsim_tpu_torch.models import pmt
    inst = bench_instructions(512, 2000, 300)
    params, const, got = truth_inputs(default_config(seed=1234,
                                                     chunk_size=100),
                                      inst, dev, 20261016)
    params_x, const_x, got_x = truth_inputs(
        default_config(detector='XENON1T', seed=1234, chunk_size=100), inst,
        dev, 20261016)
    count = getattr(pmt, 'pmt_truth_second_pass', None)
    guard = getattr(pmt, 'row_truth_second_pass_ref', None)
    ph2, e2 = got['s2']
    skew, e_skew = skewed_truth_copy(ph2, e2, 20261017)
    rows = []
    for name, (ph, edges) in (('row_truth_s1', got['s1']),
                              ('row_truth_s2', (ph2, e2)),
                              ('row_truth_skewed', (skew, e_skew))):
        R = int(edges.shape[0]) - 1

        def twin(ph=ph, edges=edges, R=R):
            out = pmt.pulse_truth_ref(params, const, ph, edges)
            out.update(pmt.photon_time_stats_ref(
                ph['t'], ph['valid'], ph['truth_row'], R, edges))
            return out
        rows.append((name, 0, lambda ph=ph, edges=edges: pmt._row_truth(
            params, const, ph['t'], ph['valid'], edges, ph=ph), twin,
            row_truth_library(params, const, ph, edges), ph, edges, True,
            FLOAT_TRUTH, params, const))
    t_e, row_e, e_e = got['electrons']
    ph_e = dict(t=t_e, truth_row=row_e)
    rows.append(('row_truth_electrons', 0,
                 lambda: pmt._row_truth(None, None, t_e, None, e_e),
                 lambda: pmt.photon_time_stats_ref(
                     t_e, None, row_e, int(e_e.shape[0]) - 1, e_e),
                 row_truth_library(None, None, ph_e, e_e), ph_e, e_e, False,
                 FLOAT_TRUTH, None, None))
    for name, prm, cst, (ph, edges) in (
            ('per_pmt_494', params, const, (ph2, e2)),
            ('per_pmt_248', params_x, const_x, got_x['s2']),
            ('per_pmt_skewed', params, const, (skew, e_skew))):
        rows.append((name, 1, lambda a=(prm, cst, ph, edges):
                     tuple(pmt.pulse_truth_per_pmt(*a).values()),
                     lambda a=(prm, cst, ph, edges):
                     tuple(pmt.pulse_truth_per_pmt_ref(*a).values()),
                     per_pmt_library(prm, cst, ph, edges), ph, edges, True,
                     (4, 5), prm, cst))
    res = {}
    for (name, which, kernel, plain, library, ph, edges, channels, rtol,
         prm, cst) in rows:
        out = kernel()
        want = plain()
        err = compare(out, want, name, rtol)
        lib_err = compare(library(), want, name + ' library', rtol)
        again = compare(kernel(), out, name + ' second call')
        if again:
            raise AssertionError(f'{name}: two calls differ')
        seq = want_seq = None
        if count is not None:
            count(dev).zero_()
            kernel()
            seq = count(dev).tolist()
            mom, area = guard(prm, cst, ph['t'], ph.get('valid'), edges,
                              ph=ph if channels else None)
            n_m, n_a = int(mom.sum()), int(area.sum())
            want_seq = [n_m, n_a, 0] if which == 0 else [0, 0, n_a]
            if seq != want_seq:
                raise AssertionError(f'{name}: second-pass rows {seq}, the '
                                     f'twin {want_seq}')
        n_sync, where = count_syncs(kernel)
        limit = None if max_syncs is None else max_syncs[which]
        if limit is not None and n_sync > limit:
            raise AssertionError(f'{name}: {n_sync} read-backs a call, more '
                                 f'than {limit} ({where})')
        dev_ms, by_name = device_ms(kernel)
        split = {}
        for k, v in by_name.items():            # names cut to 60 characters
            split[k[:60]] = split.get(k[:60], 0.0) + v
        n_bytes, ops32 = truth_work(ph, edges, out, prm)
        m = res[name] = dict(
            err=err, ms=cuda_ms(kernel), device_ms=dev_ms,
            plain_ms=cuda_ms(plain, reps=5), host_us=host_us(kernel, 1000),
            bytes=n_bytes, ops32=ops32, ops64=0,
            library_ms=cuda_ms(library, reps=5), library_diff=lib_err,
            syncs=n_sync, second_pass=seq, split=split,
            photons=int(ph['t'].shape[0]), rows=int(edges.shape[0]) - 1)
        b_ms, b_by = bound(n_bytes, ops32)
        dev_s = ('not measured' if dev_ms is None else f'{dev_ms:.4f} ms '
                 + str({k: round(v, 6) for k, v in split.items()}))
        print(f'[truth] {name}: {m["photons"]} elements in {m["rows"]} rows '
              f'(largest {int((edges[1:] - edges[:-1]).max())}), max|diff| '
              f'{err}, library max|diff| {lib_err}, second call bitwise, '
              f'read-backs {n_sync} {where}, second-pass rows {seq} (twin '
              f'{want_seq}), {m["ms"]:.4f} ms, device {dev_s}, host '
              f'{m["host_us"]:.2f} us a call, plain twin '
              f'{m["plain_ms"]:.4f} ms, library {m["library_ms"]:.4f} ms, '
              f'bound {b_ms:.6f} ms by {b_by} ({smi})')
    if count is not None:
        count(dev).zero_()
    torch.cuda.synchronize()
    from wfsim_tpu_torch import _build
    bufs = getattr(_build, 'SCRATCH', getattr(pmt, '_SCRATCH', {}))
    for key, buf in bufs.items():
        if (key[0] if isinstance(key, tuple) else key) == dev and buf.any():
            raise AssertionError(f'the truth scratch of {key} is not zero')
    return res


def pmt_truth_layouts_measure(dev, smi, max_syncs=None):
    """The truth kernels' layout choices on pmt_truth_measure's batches:
    the row kernel on the S2 photons (with channels and without) under
    each (block_rows, chunk) of ROW_TRUTH_LAYOUTS, and on the skewed copy
    under the one it picks; the per-PMT kernel (494 channels) on the S2
    photons and the skewed copy under each chunk of PER_PMT_CHUNKS.  Every
    output is bitwise that of the wrapper's own choice (the kernels' sums
    are exact integers: the cut does not change them).  ``max_syncs`` is
    unused (``ab_port.py --only`` passes it).  Returns {row name:
    {device_ms, split, photons, rows}}."""
    from wfsim_tpu_torch.config import default_config
    from wfsim_tpu_torch.interface import bench_instructions
    from wfsim_tpu_torch.models import pmt
    del max_syncs
    inst = bench_instructions(512, 2000, 300)
    params, const, got = truth_inputs(default_config(seed=1234,
                                                     chunk_size=100),
                                      inst, dev, 20261016)
    ph, e = got['s2']
    skew, e_skew = skewed_truth_copy(ph, e, 20261017)
    calls = {
        'row_truth_s2': lambda: pmt._row_truth(params, const, ph['t'],
                                               ph['valid'], e, ph=ph),
        'row_stats_s2': lambda: pmt._row_truth(None, None, ph['t'],
                                               ph['valid'], e),
        'row_truth_skewed': lambda: pmt._row_truth(
            params, const, skew['t'], skew['valid'], e_skew, ph=skew),
        'per_pmt_494': lambda: pmt.pulse_truth_per_pmt(params, const, ph, e),
        'per_pmt_skewed': lambda: pmt.pulse_truth_per_pmt(params, const,
                                                          skew, e_skew)}
    want = {k: f() for k, f in calls.items()}
    layout, chunk = pmt.row_truth_layout, pmt.PER_PMT_CHUNK
    res = {}

    def one(name, row, lay):
        out = calls[row]()
        compare(out, want[row], name)
        ms, split = device_ms(calls[row], reps=30)
        n_ph = int((skew if 'skewed' in row else ph)['t'].shape[0])
        res[name] = dict(device_ms=ms, split=split, photons=n_ph,
                         rows=int((e_skew if 'skewed' in row
                                   else e).shape[0]) - 1)
        print(f'[truth layouts] {name} {lay}: {ms} ms, bitwise the '
              f'default ({smi})')
    try:
        for lay in ROW_TRUTH_LAYOUTS:
            pmt.row_truth_layout = lambda n, R, lay=lay: lay
            for row in ('row_truth_s2', 'row_stats_s2'):
                one(f'{row}_{"block" if lay[0] else "warp"}_{lay[1]}', row,
                    lay)
        pmt.row_truth_layout = layout
        one('row_truth_skewed', 'row_truth_skewed', 'default')
        for c in PER_PMT_CHUNKS:
            pmt.PER_PMT_CHUNK = c
            for row in ('per_pmt_494', 'per_pmt_skewed'):
                one(f'{row}_chunk_{c}', row, c)
    finally:
        pmt.row_truth_layout, pmt.PER_PMT_CHUNK = layout, chunk
    return res


#: phase 3o's skewed S2 batch: instruction 100 holds 10^6 photons, one of
#: its electrons 10^5 of them (PHOTON_SKEWED), instructions 3, 200 and 511
#: have no electrons and a tenth of the other electrons no photons
PHOTON_SKEWED = dict(inst=100, photons=1_000_000, electron=100_000,
                     no_electrons=(3, 200, 511), no_photons=0.1)


def detector_s2_batch(dev, seed):
    """The detector_physics S2 batch (physics_batches of that configuration
    with S1 timing left simple: its NEST tables take ~12 s to build, and
    the S2 batch needs none), with the pattern map written into a
    temporary directory: (params, const, S2 inst dict, draws)."""
    from wfsim_tpu_torch.config import (default_config,
                                        detector_physics_overrides)
    from wfsim_tpu_torch.interface import detector_physics_instructions
    from wfsim_tpu_torch.resources.synthetic import write_pattern_map
    tmp = tempfile.mkdtemp(prefix='wfsim_smoke_')
    try:
        over = detector_physics_overrides(
            write_pattern_map(Path(tmp) / 's2_pattern_map.json', 1234))
        over['s1_model_type'] = 'simple'
        params, const, batches = physics_batches(
            default_config(seed=1234, chunk_size=100, **over),
            detector_physics_instructions(512, 2000, 300), dev, seed)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    x2, _n, d2 = batches['s2']
    return params, const, x2, d2


def skewed_s2_times_batch(const, dev, seed):
    """PHOTON_SKEWED's batch of 512 instructions with the bench's mean
    electrons (176) and photons an electron (17.5) elsewhere: every input
    of the electron and photon time kernels, made from ``seed`` (times
    and truth rows per instruction, electron draws, the simple model's
    tables, photon draws and electron times)."""
    import torch
    from wfsim_tpu_torch.models.s2 import luminescence_tables
    rng = np.random.default_rng(seed)
    cfg = PHOTON_SKEWED
    I, big = 512, cfg['inst']
    e_counts = rng.poisson(176, I)
    e_counts[list(cfg['no_electrons'])] = 0
    n_big = (cfg['photons'] - cfg['electron']) // 17 + 1
    e_counts[big] = n_big
    e_edges = np.concatenate([[0], np.cumsum(e_counts)])
    E = int(e_edges[-1])
    ph = rng.poisson(17.5, E)
    ph[rng.random(E) < cfg['no_photons']] = 0
    k0 = e_edges[big]
    ph[k0:k0 + n_big] = 17
    ph[k0 + 7] = cfg['electron']
    ph[k0 + 8] += cfg['photons'] - int(ph[k0:k0 + n_big].sum())
    e_ph_edges = np.concatenate([[0], np.cumsum(ph)])
    n = int(e_ph_edges[-1])
    f32 = np.float32

    def t(a):
        return torch.as_tensor(a, device=dev)
    return dict(
        time=t((np.arange(I) * 4_000_000).astype(np.int32)),
        e_edges=t(e_edges), e_ph_edges=t(e_ph_edges),
        mean=t(rng.uniform(0, 2e5, I).astype(f32)),
        spread=t(rng.uniform(0, 300, I).astype(f32)),
        e_exp=t(rng.exponential(size=E).astype(f32)),
        e_normal=t(rng.normal(size=E).astype(f32)),
        truth_row=t(np.arange(I, dtype=np.int64)),
        inv=luminescence_tables(const, I, dev),
        u_lum=t(rng.random(n, dtype=f32)), u_st=t(rng.random(n, dtype=f32)),
        exp_st=t(rng.exponential(size=n).astype(f32)),
        t_spread=t(rng.normal(size=n).astype(f32)))


def s1_times_rows(dev):
    """The S1 photon time rows (K9 S1) of photon_times_measure, in
    photon_times_rows' form: the default run's S1 batch (6,925 photons in
    512 instructions; the simple model), its S1_SKEWED copy (instruction
    100 of 10^5 photons, fresh exp and normal draws), and the
    timing_models and detector_physics S1 batches given their custom and
    NEST delays.  Each row's dropped bytes are the segment ids (8 bytes a
    photon) the kernel wrote before."""
    import torch
    from wfsim_tpu_torch.config import (default_config,
                                        detector_physics_overrides,
                                        timing_models_overrides)
    from wfsim_tpu_torch.interface import (bench_instructions,
                                           detector_physics_instructions,
                                           timing_models_instructions)
    from wfsim_tpu_torch.models import s1
    from wfsim_tpu_torch.ops.segment import edges_from_counts
    from wfsim_tpu_torch.resources.synthetic import (write_garfield_table,
                                                     write_pattern_map)
    _p, const, batches = physics_batches(
        default_config(seed=1234, chunk_size=100),
        bench_instructions(512, 2000, 300), dev, 20261016)
    tmp = tempfile.mkdtemp(prefix='wfsim_smoke_s1t_')
    try:
        _p, const_t, b_t = physics_batches(
            default_config(seed=1234, chunk_size=100,
                           **timing_models_overrides(write_garfield_table(
                               Path(tmp) / 'garfield.npz', 1234))),
            timing_models_instructions(512, 2000, 300), dev, 20261016)
        params_d, const_d, b_d = physics_batches(
            default_config(seed=1234, chunk_size=100,
                           **detector_physics_overrides(write_pattern_map(
                               Path(tmp) / 's2_pattern_map.json', 1234))),
            detector_physics_instructions(512, 2000, 300), dev, 20261016)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    kw = dict(decay_time=const.s1_decay_time,
              decay_spread=const.s1_decay_spread)
    x1, _n, d1 = batches['s1']
    counts = d1['n_hits'].long().clone()
    counts[S1_SKEWED['inst']] = S1_SKEWED['photons']
    n_sk = int(counts.sum())
    gen = torch.Generator(device=dev)
    gen.manual_seed(20261018)
    xt, _n, dt = b_t['s1']
    xd, _n, dd = b_d['s1']
    e_t, e_d = edges_from_counts(dt['n_hits']), edges_from_counts(
        dd['n_hits'])
    cases = {
        's1_photon_times': (x1, edges_from_counts(d1['n_hits']), d1['exp'],
                            d1['normal'], None, None),
        's1_photon_times_skewed': (
            x1, edges_from_counts(counts),
            torch.empty(n_sk, device=dev).exponential_(1.0, generator=gen),
            torch.randn(n_sk, device=dev, generator=gen), None, None),
        's1_photon_times_custom': (
            xt, e_t, None, None, None,
            s1.custom_delays(s1.recoil_class(xt['recoil']), e_t,
                             dt['custom'], const=const_t)),
        's1_photon_times_nest': (
            xd, e_d, None, None,
            s1.nest_delays(*s1.nest_inputs(params_d, const_d, xd), e_d,
                           dd['u_nest']), None)}
    rows = {}
    for name, (x, edges, ex, nrm, nest, custom) in cases.items():
        args = (x['time'], edges, x['truth_row'], ex, nrm, nest, custom)
        n = int(edges[-1])
        rows[name] = (
            1, lambda a=args: s1.s1_photon_times(*a, **kw),
            lambda a=args: s1.s1_photon_times_ref(*a, **kw),
            tuple(a for a in args if a is not None), n * 8,
            n * (4 if ex is not None else 2), 0, n, int(x['x'].shape[0]))
    return rows


def photon_times_rows(dev):
    """The rows of photon_times_measure: {name: (which, kernel, twin, the
    tensors the function reads, the bytes of the outputs that the kernels
    no longer write, float32 operations, float64 operations, elements,
    segments)}; ``which`` indexes max_syncs (0 the gas-gap sampler, 1 the
    S1 and S2 time kernels)."""
    import inspect
    import torch
    from wfsim_tpu_torch.config import default_config
    from wfsim_tpu_torch.interface import bench_instructions
    from wfsim_tpu_torch.models import s2
    params, const, batches = physics_batches(
        default_config(seed=1234, chunk_size=100),
        bench_instructions(512, 2000, 300), dev, 20261016)
    x2, _n2, d2 = batches['s2']
    rows = s1_times_rows(dev)
    def add_times(tag, cst, x, d, inv=None, t_lum=None, e_in=None):
        t_kw = dict(singlet_fraction=cst.singlet_fraction_gas,
                    t_singlet=cst.singlet_lifetime_gas,
                    t_triplet=cst.triplet_lifetime_gas,
                    time_spread=cst.s2_time_spread, t_lum=t_lum)
        e_kw = dict(trapping=cst.electron_trapping_time)
        if e_in is None:
            e_edges, e_ph_edges, _ph = s2.s2_edges(d)
            mean, spread = s2.get_s2_drift_time_params(
                None, cst, x['z'], torch.stack([x['x'], x['y']], dim=1))
            e_in = (x['time'], e_edges, mean, spread, d['e_exp'],
                    d['e_normal'], x['truth_row'])
        else:
            e_edges, e_ph_edges = d['e_edges'], d['e_ph_edges']
        n_e, n_i = int(e_in[4].shape[0]), int(e_in[0].shape[0])
        if tag is not None:
            rows['s2_electron_times' + tag] = (
                1, lambda: s2.s2_electron_times(*e_in, **e_kw),
                lambda: s2.s2_electron_times_ref(*e_in, **e_kw), e_in,
                n_e * 8, n_e * 5, 0, n_e, n_i)
        e_t = s2.s2_electron_times(*e_in, **e_kw)[0]
        args = (inv, e_edges, e_ph_edges, e_t, e_in[6],
                None if inv is None else d['u_lum'], d['u_st'], d['exp_st'],
                d['t_spread'])
        n = int(d['u_st'].shape[0])
        rows['s2_photon_times' + ('_gasgap' if tag is None else tag)] = (
            1, lambda: s2.s2_photon_times(*args, **t_kw),
            lambda: s2.s2_photon_times_ref(*args, **t_kw),
            tuple(a for a in (*args, t_lum) if a is not None), n * 8,
            n * 12, 0, n, n_e)

    add_times('', const, x2, d2, inv=s2.luminescence_tables(const, 512, dev))
    skew = skewed_s2_times_batch(const, dev, 20261017)
    add_times('_skewed', const, None, skew, inv=skew['inv'], e_in=(
        skew['time'], skew['e_edges'], skew['mean'], skew['spread'],
        skew['e_exp'], skew['e_normal'], skew['truth_row']))

    params_d, const_d, xd, dd = detector_s2_batch(dev, 20261016)
    _z, xy = s2.s2_positions(params_d, const_d, xd)
    _e, _eph, ph_edges = s2.s2_edges(dd)
    gg_kw = ({'t_max': params_d.gg_t_max} if 't_max' in inspect.signature(
        s2.lumi_gasgap_times).parameters else {})
    rows_d = s2.gasgap_rows(params_d, xy)
    counts = (ph_edges[1:] - ph_edges[:-1]).cpu().numpy().copy()
    counts[PHOTON_SKEWED['inst']] = PHOTON_SKEWED['photons']
    sk_edges = torch.as_tensor(np.concatenate([[0], np.cumsum(counts)]),
                               device=dev)
    u_sk = torch.as_tensor(np.random.default_rng(20261018).random(
        int(counts.sum()), dtype=np.float32), device=dev)
    for name, edges, u in (('lumi_gasgap_times', ph_edges, dd['u_lum']),
                           ('lumi_gasgap_times_skewed', sk_edges, u_sk)):
        args = (params_d.gg_inv_cdf, *rows_d, edges, u)
        n = int(u.shape[0])
        rows[name] = (0, lambda a=args: (s2.lumi_gasgap_times(*a, **gg_kw),),
                      lambda a=args: (s2.lumi_gasgap_times_ref(*a),), args,
                      0, n * 16, n * 2, n, int(edges.shape[0]) - 1)
    t_lum = s2.lumi_gasgap_times(params_d.gg_inv_cdf, *rows_d, ph_edges,
                                 dd['u_lum'], **gg_kw)
    add_times(None, const_d, xd, dd, t_lum=t_lum)
    return rows


def photon_times_measure(dev, smi, max_syncs=(0, 0), rows=None):
    """Phase 3o: the gas-gap luminescence times (K13a) on the
    detector_physics S2 batch and a copy whose instruction 100 holds 10^6
    photons, the S2 photon times (K9) on the default run's S2 batch
    (the simple model's tables), on the detector_physics one (given
    gas-gap times) and on PHOTON_SKEWED's batch, with the S2 electron
    times of the default and the skewed batch, and the S1 photon times on
    s1_times_rows' four batches (``rows``, photon_times_rows' form, in
    place of them all where given): each bitwise against its twin, the
    same bits on a second call, its host syncs a call (at most
    ``max_syncs``, the gas-gap sampler's and the S1 and S2 time
    kernels'; None counts without a limit, for another checkout's
    wrappers), ``ms``, ``device_ms`` split by kernel, ``host_us`` over
    1,000 calls, the twin's time and the bound: the bytes the function
    reads once and writes, with the old count beside it (the segment ids
    the kernels wrote before, 8 bytes an element).  The scratch buffers
    are checked to be zero at the end.  Returns {row name: measurements
    (see make_check)}."""
    import torch
    from wfsim_tpu_torch import _build
    res = {}
    rows = photon_times_rows(dev) if rows is None else rows
    for name, (which, kernel, plain, inputs, dropped, ops32, ops64, n,
               segs) in rows.items():
        out = kernel()
        want = plain()
        err = compare(out, want, name)
        if compare(kernel(), out, name + ' second call'):
            raise AssertionError(f'{name}: two calls differ')
        n_sync, where = count_syncs(kernel)
        limit = None if max_syncs is None else max_syncs[which]
        if limit is not None and n_sync > limit:
            raise AssertionError(f'{name}: {n_sync} read-backs a call, more '
                                 f'than {limit} ({where})')
        if limit == 0:
            sync_free(name, kernel)
        dev_ms, by_name = device_ms(kernel)
        split = {}
        for k, v in by_name.items():            # names cut to 60 characters
            split[k[:60]] = split.get(k[:60], 0.0) + v
        # the old count held the segment ids; a checkout still writing them
        # has them in its outputs
        wrote_ids = len(out) == 3 and dropped
        n_bytes = nbytes(inputs, out) - (dropped if wrote_ids else 0)
        m = res[name] = dict(
            err=err, ms=cuda_ms(kernel), device_ms=dev_ms,
            plain_ms=cuda_ms(plain, reps=5), host_us=host_us(kernel, 1000),
            bytes=n_bytes, bytes_old=n_bytes + dropped, ops32=ops32,
            ops64=ops64, library_ms=None, syncs=n_sync, split=split,
            photons=n, rows=segs)
        b_ms, b_by = bound(n_bytes, ops32, ops64)
        b_old = bound(n_bytes + dropped, ops32, ops64)[0]
        dev_s = ('not measured' if dev_ms is None else f'{dev_ms:.4f} ms '
                 + str({k: round(v, 6) for k, v in split.items()}))
        print(f'[times] {name}: {n} elements in {segs} segments, max|diff| '
              f'{err}, second call bitwise, read-backs {n_sync} {where}, '
              f'{m["ms"]:.4f} ms, device {dev_s}, host '
              f'{m["host_us"]:.2f} us a call, plain twin '
              f'{m["plain_ms"]:.4f} ms, bound {b_ms:.6f} ms by {b_by} (old '
              f'count {b_old:.6f}) ({smi})')
    torch.cuda.synchronize()
    for key, buf in getattr(_build, 'SCRATCH', {}).items():
        if key[0] == dev and buf.any():
            raise AssertionError(f'the kernels\' scratch of {key} is not '
                                 f'zero')
    return res


def s1_times_measure(dev, smi, max_syncs=0):
    """The S1 photon time rows of phase 3o alone (s1_times_rows; for
    ``ab_port.py --kernels --only s1_times``): photon_times_measure on
    them, at most ``max_syncs`` host syncs a call (None: no limit)."""
    return photon_times_measure(
        dev, smi, rows=s1_times_rows(dev),
        max_syncs=None if max_syncs is None else (max_syncs, max_syncs))


#: the step shard's skewed copies (phase 3i, step_block_measure): row
#: STEP_SKEW['row'] of the bench shard's block holds 10^5 photons, in
#: 'skewed' times and gains drawn from the whole shard's photons (the
#: channel sees ~500 times its neighbours' light at the same events'
#: times), in 'burst' one pulse at the shard's median time (exponential,
#: mean 60 ns: ~300 ns)
STEP_SKEW = dict(row=300, photons=100_000, burst_mean_ns=60.0)


def with_row(bp, row, t_row, g_row):
    """block_photons' dict ``bp`` with row ``row``'s photons replaced."""
    import torch
    rp = bp['row_ptr']
    a, b = int(rp[row]), int(rp[row + 1])
    dev = rp.device
    t_row = torch.as_tensor(t_row, dtype=torch.int32, device=dev)
    g_row = torch.as_tensor(g_row, dtype=torch.float32, device=dev)
    row_ptr = rp.clone()
    row_ptr[row + 1:] += t_row.shape[0] - (b - a)
    return dict(t=torch.cat([bp['t'][:a], t_row, bp['t'][b:]]).contiguous(),
                gain=torch.cat([bp['gain'][:a], g_row,
                                bp['gain'][b:]]).contiguous(),
                row_ptr=row_ptr)


def step_block_rows(dev):
    """The rows of step_block_measure: {name: (args, kw)} of the channel
    block of one step shard (64 instructions of ``step_instructions`` in a
    2^16-sample grid, all 494 channels in one block: the 1 x 1 step's
    call) and its STEP_SKEW copies; prints each row's tiles a row-range
    skip could spare (tiles outside a row's [min s, max s + L)) and the
    tiles with a hit."""
    import torch
    from wfsim_tpu_torch.config import default_config
    from wfsim_tpu_torch.interface import step_instructions
    from wfsim_tpu_torch.models.params import build_params, build_constants
    from wfsim_tpu_torch.parallel.sharding import (
        block_photons, seeded_generator, simulate_block)
    from wfsim_tpu_torch.resources import load_config
    cfg = default_config(seed=1234, chunk_size=100)
    params = build_params(cfg, load_config(cfg), dev)
    const = build_constants(cfg)
    C, dt = const.n_tpc_pmts, const.sample_duration
    inst = step_instructions(cfg, 1, STEP_SHARD, STEP_T)
    ph, _tot = simulate_block(params, const, inst,
                              seeded_generator(1234, 0, dev))
    bp = block_photons(ph, torch.zeros(ph['t'].shape[0], dtype=torch.int64,
                                       device=dev),
                       n_blocks=1, ch_block=0, n_channels=C,
                       n_samples=STEP_T, sample_duration=dt)
    kw = dict(n_channels=C, ch_block=0, n_top=const.n_top_pmts, n_tpc=C,
              current_2_adc=const.current_2_adc, n_samples=STEP_T)
    rng = np.random.default_rng(20261019)
    n_big = STEP_SKEW['photons']
    pick = torch.as_tensor(rng.integers(0, bp['t'].shape[0], n_big),
                           device=dev)
    t0 = int(bp['t'].float().median())
    burst = t0 + rng.exponential(STEP_SKEW['burst_mean_ns'], n_big)
    shards = {'superpose_block': bp,
              'superpose_block_skewed': with_row(
                  bp, STEP_SKEW['row'], bp['t'][pick], bp['gain'][pick]),
              'superpose_block_burst': with_row(
                  bp, STEP_SKEW['row'], burst.astype(np.int32),
                  bp['gain'][pick])}
    L = int(params.templates.shape[1])
    rows = {}
    for name, b in shards.items():
        rp = b['row_ptr'].cpu().numpy()
        s = b['t'].cpu().numpy() // dt
        n_seg, spare, lit = -(-STEP_T // 1024), 0, 0
        for r in range(C):
            sr = s[rp[r]:rp[r + 1]]
            if not len(sr):
                spare += n_seg
                continue
            lo, hi = sr.min(), sr.max() + L
            tiles = np.arange(n_seg) * 1024
            spare += int(((tiles + 1024 <= lo) | (tiles >= hi)).sum())
            hit = np.zeros(n_seg, bool)
            hit[np.unique(sr // 1024)] = True
            hit[np.unique(np.minimum(sr + L - 1, STEP_T - 1) // 1024)] = True
            lit += int(hit.sum())
        print(f'[kernels-m] {name}: {int(b["t"].shape[0])} photons in {C} '
              f'rows of {STEP_T} samples, longest row '
              f'{int(np.diff(rp).max())}; of {C * n_seg} tiles of 1,024 '
              f'samples {spare} lie outside their row\'s photon range (a '
              f'row-range skip spares their scans), {lit} have a hit')
        rows[name] = ((b['t'], b['gain'], b['row_ptr'], params.templates), kw)
    return rows


def block_library(args, kw, how):
    """K14 in PyTorch around one library call: ``library_waveform`` of the
    block's photons, ``-round(W * c2a)`` as int32 and the bottom-array sum
    rows by one ``sum`` (only the photons' row offsets and the rows'
    bottom mask are computed outside the returned call)."""
    import torch
    t, gain, row_ptr, templates = args
    T, C = kw['n_samples'], kw['n_channels']
    n_rows = row_ptr.shape[0] - 1
    wave = library_waveform(t, gain, row_ptr, templates, T, how)
    ch = kw['ch_block'] + torch.arange(n_rows, device=t.device) % C
    bottom = ((ch >= kw['n_top']) & (ch < kw['n_tpc']))[:, None]
    c2a = float(np.float32(kw['current_2_adc']))

    def call():
        adc = (-torch.round(wave() * c2a)).to(torch.int32)
        return adc, torch.where(bottom, adc, 0).view(-1, C, T).sum(
            dim=1, dtype=torch.int32)
    return call


def step_block_measure(dev, smi, max_syncs=1):
    """K14 on the step shard and its skewed and burst copies
    (step_block_rows): each bitwise against its twin and the same bits on
    a second call, its host syncs a call (at most ``max_syncs``; None
    counts without a limit, for another checkout's wrapper), ``ms``,
    ``device_ms`` split by kernel, ``host_us`` over 1,000 calls, the
    twin's time (one call), the bound (the photons read once, the int32
    grid and sum rows written once) and two library computations
    (block_library: ``conv1d`` and ``index_add_``), the faster the row's
    ``library_ms``.  Returns {row name: measurements (see make_check)}."""
    import torch
    from wfsim_tpu_torch.ops.waveform import (superpose_block,
                                              superpose_block_ref)
    res = {}
    for name, (args, kw) in step_block_rows(dev).items():
        def kernel(a=args, k=kw):
            return superpose_block(*a, **k)
        out = kernel()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        want = superpose_block_ref(*args, **kw)
        end.record()
        torch.cuda.synchronize()
        plain = start.elapsed_time(end)
        err = compare(out, want, name)
        if compare(kernel(), out, name + ' second call'):
            raise AssertionError(f'{name}: two calls differ')
        del want
        n_sync, where = count_syncs(kernel)
        if max_syncs is not None and n_sync > max_syncs:
            raise AssertionError(f'{name}: {n_sync} read-backs a call, more '
                                 f'than {max_syncs} ({where})')
        # the entry's records: its kernel, the memset of the sum rows and
        # the status copy (the parent's t.min() reduction)
        n_ph = int(args[0].shape[0])
        ops = n_ph * int(args[3].shape[1]) * 2 + out[0].numel() * 3
        n_bytes = nbytes(args, out)
        b_ms, b_by = bound(n_bytes, ops)
        dev_ms, by_name = bounded_device_ms(name, kernel, (
            'superpose_block_kernel', 'Memset', 'Memcpy DtoH',
            'reduce_kernel'), b_ms)
        split = {}
        for k, v in by_name.items():
            split[k[:60]] = split.get(k[:60], 0.0) + v
        libs = {}
        for how in SUPERPOSE_LIBRARY:
            lib = block_library(args, kw, how)
            diff = int((lib()[0] != out[0]).sum())
            libs[how] = (cuda_ms(lib, reps=10), diff)
        best = min(libs, key=lambda h: libs[h][0])
        ms = cuda_ms(kernel)
        m = res[name] = dict(
            err=err, ms=ms, device_ms=dev_ms, plain_ms=plain,
            # ~1,000 calls, fewer where a call is slow (another checkout)
            host_us=host_us(kernel, max(10, min(1000, int(500 / ms)))),
            bytes=n_bytes, ops32=ops,
            ops64=0, library_ms=libs[best][0], library_call=best,
            library_calls={h: v[0] for h, v in libs.items()},
            library_diff={h: v[1] for h, v in libs.items()}, syncs=n_sync,
            split=split, photons=n_ph)
        dev_s = ('not measured' if dev_ms is None else f'{dev_ms:.4f} ms '
                 + str({k: round(v, 6) for k, v in split.items()}))
        print(f'[kernels-m] {name}: {n_ph} photons, max|diff| {err}, second '
              f'call bitwise, read-backs {n_sync} {where}, {m["ms"]:.4f} ms, '
              f'device {dev_s}, host {m["host_us"]:.2f} us a call, plain '
              f'twin {plain:.4f} ms (one call), library '
              f'{ {h: round(v[0], 4) for h, v in libs.items()} } ms '
              f'(samples differing from the twin '
              f'{ {h: v[1] for h, v in libs.items()} }), bound {b_ms:.6f} ms '
              f'by {b_by} ({n_bytes / 1e6:.1f} MB) ({smi})')
        del out
    return res


#: the garfield rows' skewed batch: instruction 100 of the timing_models S2
#: batch holds 10^6 photons (fresh columns), instructions 3, 200 and 511 none
GARFIELD_SKEWED = dict(inst=100, photons=1_000_000, empty=(3, 200, 511))


def garfield_rows(dev):
    """The rows of garfield_measure: {name: (args, u_wire, kw)} of K13c on
    the timing_models S2 batch (512 instructions, ~1.57 M photons) in the
    wire-rotation and the confine mode, and on GARFIELD_SKEWED's copy in
    the wire-rotation mode."""
    import torch
    from wfsim_tpu_torch.config import default_config, timing_models_overrides
    from wfsim_tpu_torch.interface import timing_models_instructions
    from wfsim_tpu_torch.models import s2
    from wfsim_tpu_torch.resources.synthetic import write_garfield_table
    tmp = tempfile.mkdtemp(prefix='wfsim_smoke_gf_')
    try:
        cfg = default_config(seed=1234, chunk_size=100,
                             **timing_models_overrides(write_garfield_table(
                                 Path(tmp) / 'garfield.npz', 1234)))
        params, const, batches = physics_batches(
            cfg, timing_models_instructions(512, 2000, 300), dev, 20261016)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    x2, _n2, d2 = batches['s2']
    _e, _eph, ph_edges = s2.s2_edges(d2)
    _z, xy = s2.s2_positions(params, const, x2)
    n_i = int(xy.shape[0])
    kw = dict(avgt=params.garfield_avgt, tilt=const.anode_xaxis_angle,
              pitch=const.anode_pitch)
    table = (params.garfield_t, params.garfield_x)
    counts = (ph_edges[1:] - ph_edges[:-1]).cpu().numpy().copy()
    counts[GARFIELD_SKEWED['inst']] = GARFIELD_SKEWED['photons']
    counts[list(GARFIELD_SKEWED['empty'])] = 0
    rng = np.random.default_rng(20261020)
    sk_cols = torch.as_tensor(rng.integers(
        0, params.garfield_t.shape[1], int(counts.sum())), device=dev)
    sk_edges = torch.as_tensor(np.concatenate([[0], np.cumsum(counts)]),
                               device=dev)
    u_wire = torch.rand(n_i, device=dev)
    return {
        'lumi_garfield_times': ((*table, xy, ph_edges, d2['col']), None,
                                dict(kw, confine=-1.0)),
        'lumi_garfield_times_confine': ((*table, xy, ph_edges, d2['col']),
                                        u_wire, dict(kw, confine=0.1)),
        'lumi_garfield_times_skewed': ((*table, xy, sk_edges, sk_cols), None,
                                       dict(kw, confine=-1.0))}


def garfield_library(args, u_wire, kw):
    """K13c in PyTorch around one advanced-index gather: the instructions'
    wire distances and nearest rows (the twin's torch ops at instruction
    width), then ``table[row_of_photon, cols]``, the int cast and the mean
    (each photon's instruction, a ``repeat_interleave`` of the edges, is
    computed outside the returned call)."""
    import torch
    from wfsim_tpu_torch.models.s2 import tilt_coefficients
    table, x_axis, xy, ph_edges, cols = args
    counts = ph_edges[1:] - ph_edges[:-1]
    inst = torch.repeat_interleave(torch.arange(xy.shape[0], device=xy.device),
                                   counts, output_size=cols.shape[0])
    f = lambda v: torch.tensor(np.float32(v), device=xy.device)  # noqa: E731
    s, co = tilt_coefficients(kw['tilt'])

    def call():
        if u_wire is not None:
            c = f(kw['confine'])
            d = torch.maximum(-c, u_wire * (c + c) + (-c))
        else:
            rot_y = xy[:, 0] * f(s) + xy[:, 1] * f(co)
            p, half = f(kw['pitch']), f(kw['pitch'] / 2)
            r = torch.fmod(rot_y + half, p)
            d = torch.where((r != 0) & ((r < 0) != (p < 0)), r + p, r) - half
        rows = torch.argmin(torch.abs(d[:, None] - x_axis[None, :]), dim=1)
        return table[rows[inst], cols].to(torch.int32) - kw['avgt']
    return call


def garfield_measure(dev, smi, max_syncs=0):
    """K13c (phase 3f) on the garfield_rows batches: each bitwise against
    its twin and against the library computation (garfield_library), the
    same bits on a second call, its host syncs a call (at most
    ``max_syncs``; None counts without a limit, for another checkout's
    wrapper), ``ms``, ``device_ms`` split by kernel, ``host_us`` over
    1,000 calls, the twin's and the library computation's time and the
    bound (cols read, t written, the table, xy or u_wire and the edges
    read once).  Returns {row name: measurements (see make_check)}."""
    from wfsim_tpu_torch.models import s2
    res = {}
    for name, (args, u_wire, kw) in garfield_rows(dev).items():
        n = int(args[4].shape[0])
        n_i = int(args[2].shape[0])

        def kernel(a=args, u=u_wire, k=kw):
            return (s2.lumi_garfield_times(*a, u, **k),)

        def plain(a=args, u=u_wire, k=kw):
            return (s2.lumi_garfield_times_ref(*a, u, **k),)
        out = kernel()
        err = compare(out, plain(), name)
        if compare(kernel(), out, name + ' second call'):
            raise AssertionError(f'{name}: two calls differ')
        lib = garfield_library(args, u_wire, kw)
        compare((lib(),), out, name + ' library computation')
        n_sync, where = count_syncs(kernel)
        if max_syncs is not None and n_sync > max_syncs:
            raise AssertionError(f'{name}: {n_sync} read-backs a call, more '
                                 f'than {max_syncs} ({where})')
        if max_syncs == 0:
            sync_free(name, kernel)
        R = int(args[0].shape[0])
        ops = n_i * R * 3 + n * 2
        inputs = (args, u_wire if u_wire is not None else ())
        n_bytes = nbytes(inputs, out)
        b_ms, b_by = bound(n_bytes, ops)
        # the entry's records: its kernel (the parent's rows kernel and
        # read-back too)
        dev_ms, by_name = bounded_device_ms(name, kernel, (
            'garfield_times_kernel', 'garfield_rows_kernel', 'Memcpy DtoH'),
            b_ms)
        split = {}
        for k, v in by_name.items():
            split[k[:60]] = split.get(k[:60], 0.0) + v
        m = res[name] = dict(
            err=err, ms=cuda_ms(kernel), device_ms=dev_ms,
            plain_ms=cuda_ms(plain, reps=5), host_us=host_us(kernel, 1000),
            bytes=n_bytes, ops32=ops, ops64=0, library_ms=cuda_ms(lib),
            syncs=n_sync, split=split, photons=n, rows=n_i)
        dev_s = ('not measured' if dev_ms is None else f'{dev_ms:.4f} ms '
                 + str({k: round(v, 6) for k, v in split.items()}))
        print(f'[kernels-t] {name}: {n} photons of {n_i} instructions, '
              f'max|diff| {err}, second call and library bitwise, '
              f'read-backs {n_sync} {where}, {m["ms"]:.4f} ms, device '
              f'{dev_s}, host {m["host_us"]:.2f} us a call, plain twin '
              f'{m["plain_ms"]:.4f} ms, library call (gather) '
              f'{m["library_ms"]:.4f} ms, bound {b_ms:.6f} ms by {b_by} '
              f'({smi})')
    return res


#: the skewed copies of the S1 delays' batches: instruction 100 holds 10^5
#: photons, an alpha S1 at a few MeV (recoil id 6, e_dep 3,000 keV, past
#: the NEST energy grid)
S1_SKEWED = dict(inst=100, photons=100_000, recoil=6, e_dep=3000.0)


def s1_delays_rows(dev):
    """The rows of s1_delays_measure: {name: (wrapper, twin, args, kw,
    bytes, ops32)} of K15 on the timing_models S1 batch (512 instructions,
    recoils cycling ER, NR, alpha, LED) and of K13b on the
    detector_physics one, each also on its S1_SKEWED copy (fresh draws
    with 0 and 1 - 2^-24 among the uniforms).  bytes: what the kernel must
    read and write (K15: the classes, the edges, the draws of each
    photon's class and the delays; K13b: the per-instruction inputs, the
    edges, u, the table rows the batch's corners name and the delays);
    ops32: the arithmetic a photon (12 for K15, 32 for K13b)."""
    import torch
    from wfsim_tpu_torch.config import (default_config,
                                        detector_physics_overrides,
                                        timing_models_overrides)
    from wfsim_tpu_torch.interface import (detector_physics_instructions,
                                           timing_models_instructions)
    from wfsim_tpu_torch.models import s1
    from wfsim_tpu_torch.ops.segment import edges_from_counts
    from wfsim_tpu_torch.resources.synthetic import (write_garfield_table,
                                                     write_pattern_map)
    tmp = tempfile.mkdtemp(prefix='wfsim_smoke_s1_')
    try:
        cfg_t = default_config(seed=1234, chunk_size=100,
                               **timing_models_overrides(write_garfield_table(
                                   Path(tmp) / 'garfield.npz', 1234)))
        _p, const_t, b_t = physics_batches(
            cfg_t, timing_models_instructions(512, 2000, 300), dev, 20261016)
        cfg_d = default_config(seed=1234, chunk_size=100,
                               **detector_physics_overrides(write_pattern_map(
                                   Path(tmp) / 's2_pattern_map.json', 1234)))
        params_d, const_d, b_d = physics_batches(
            cfg_d, detector_physics_instructions(512, 2000, 300), dev,
            20261016)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    gen = torch.Generator(device=dev)
    gen.manual_seed(20261018)
    k = S1_SKEWED['inst']

    def skewed_edges(n_hits):
        counts = n_hits.long().clone()
        counts[k] = S1_SKEWED['photons']
        return edges_from_counts(counts)

    def uniforms(n):
        u = torch.rand(n, device=dev, generator=gen)
        u[::9973] = 0.0
        u[5::9973] = float(np.float32(1 - 2 ** -24))
        return u

    def photon_cls(cls, edges):
        return torch.repeat_interleave(cls, edges[1:] - edges[:-1])

    rows = {}
    x1, _n, d1 = b_t['s1']
    cls = s1.recoil_class(x1['recoil'])
    sk_cls = cls.clone()
    sk_cls[k] = int(s1.recoil_class(torch.tensor([S1_SKEWED['recoil']]))[0])
    sk_edges = skewed_edges(d1['n_hits'])
    n_sk = int(sk_edges[-1])
    sk_draws = {key: (torch.empty(n_sk, device=dev).exponential_(
        1.0, generator=gen) if key.startswith('exp') else uniforms(n_sk))
        for key in s1.CUSTOM_DRAWS}
    sk_draws['u_reco'] = s1.reco_uniform(sk_draws['u_reco'])
    excfrac = float(np.float32(const_t.er_primary_excimer_fraction))
    for name, args in (
            ('custom_delays', (cls, edges_from_counts(d1['n_hits']),
                               d1['custom'])),
            ('custom_delays_skewed', (sk_cls, sk_edges, sk_draws))):
        c, edges, draws = args
        ph = photon_cls(c, edges)
        prim = draws['u_prim'] < excfrac
        reads = torch.where(ph == 0, torch.where(prim, 3, 4),
                            torch.where(ph == 3, 1, 2))
        n = int(edges[-1])
        rows[name] = (s1.custom_delays, s1.custom_delays_ref, args,
                      dict(const=const_t),
                      nbytes(c, edges) + 4 * int(reads.sum()) + 4 * n,
                      n * 12)

    x1, _n, d1 = b_d['s1']
    sk_x = dict(x1, recoil=x1['recoil'].clone(), e_dep=x1['e_dep'].clone())
    sk_x['recoil'][k] = S1_SKEWED['recoil']
    sk_x['e_dep'][k] = S1_SKEWED['e_dep']
    sk_edges = skewed_edges(d1['n_hits'])
    for name, args in (
            ('nest_delays', (*s1.nest_inputs(params_d, const_d, x1),
                             edges_from_counts(d1['n_hits']), d1['u_nest'])),
            ('nest_delays_skewed', (*s1.nest_inputs(params_d, const_d, sk_x),
                                    sk_edges, uniforms(int(sk_edges[-1]))))):
        # the table rows the batch reads: its (class, field, energy) corners
        tbl, c, fi0, fi1, _fw, ei0, ei1, _ew = args[:8]
        corners = torch.cat([torch.stack([c, fi, ei], 1)
                             for fi in (fi0, fi1) for ei in (ei0, ei1)])
        n_rows = int(torch.unique(corners, dim=0).shape[0])
        n = int(args[9].shape[0])
        rows[name] = (s1.nest_delays, s1.nest_delays_ref, args, {},
                      nbytes(args[1:]) + n_rows * tbl.shape[-1] * 4 + 4 * n,
                      n * 32)
    return rows


def s1_delays_measure(dev, smi, max_syncs=0):
    """K15 and K13b (phase 3p) on the s1_delays_rows batches: each bitwise
    against its twin, the same bits on a second call, its host syncs a
    call (at most ``max_syncs``; None counts without a limit, for another
    checkout's wrapper), ``ms``, ``device_ms`` from the entry's own records
    (its kernel and, for a wrapper that reads back, the copy; "not
    measured" where they do not cut into calls), ``host_us`` over 1,000
    calls, the twin's time and the bound.  Returns {row name:
    measurements (see make_check)}."""
    res = {}
    for name, (fn, twin, args, kw, n_bytes, ops) in s1_delays_rows(
            dev).items():
        n_i = int(args[0 if name.startswith('custom') else 1].shape[0])
        n = int(args[1 if name.startswith('custom') else 8][-1])

        def kernel(a=args, k=kw, f=fn):
            return (f(*a, **k),)

        def plain(a=args, k=kw, f=twin):
            return (f(*a, **k),)
        out = kernel()
        err = compare(out, plain(), name)
        if compare(kernel(), out, name + ' second call'):
            raise AssertionError(f'{name}: two calls differ')
        n_sync, where = count_syncs(kernel)
        if max_syncs is not None and n_sync > max_syncs:
            raise AssertionError(f'{name}: {n_sync} read-backs a call, more '
                                 f'than {max_syncs} ({where})')
        if max_syncs == 0:
            sync_free(name, kernel)
        entry = ('custom_delays_kernel' if name.startswith('custom')
                 else 'nest_delays_kernel')
        b_ms, b_by = bound(n_bytes, ops)
        dev_ms, by_name = bounded_device_ms(name, kernel,
                                            (entry, 'Memcpy DtoH'), b_ms)
        split = {}
        for key, v in by_name.items():
            split[key[:60]] = split.get(key[:60], 0.0) + v
        m = res[name] = dict(
            err=err, ms=cuda_ms(kernel), device_ms=dev_ms,
            plain_ms=cuda_ms(plain, reps=5), host_us=host_us(kernel, 1000),
            bytes=n_bytes, ops32=ops, ops64=0, library_ms=None,
            syncs=n_sync, split=split, photons=n, rows=n_i)
        counts = args[1 if name.startswith('custom') else 8].diff()
        dev_s = ('not measured' if dev_ms is None else f'{dev_ms:.4f} ms '
                 + str({key: round(v, 6) for key, v in split.items()}))
        print(f'[kernels-s1] {name}: {n} photons of {n_i} instructions '
              f'(largest {int(counts.max())}), max|diff| {err}, second call '
              f'bitwise, read-backs {n_sync} {where}, {m["ms"]:.4f} ms, '
              f'device {dev_s}, host {m["host_us"]:.2f} us a call, plain '
              f'twin {m["plain_ms"]:.4f} ms, bound {b_ms:.6f} ms by {b_by} '
              f'({smi})')
    return res


def per_pmt_library(params, const, ph, row_edges):
    """K16 in PyTorch around one ``index_add_``: what
    ``pulse_truth_per_pmt_ref`` does around it, the photons' six terms
    (``_truth_terms``), the flat index, the float64 ``index_add_``, the
    reshape and the int32 casts, with the valid-photon gather replaced by
    a multiply by ``valid`` (an invalid photon adds 0 at its clamped
    channel: the same sums).  Only each photon's row (the repeat of the
    row edges) is computed outside the returned call."""
    import torch
    from wfsim_tpu_torch.models.pmt import PER_PMT_SUMS, _truth_terms
    dev = ph['t'].device
    C = params.gains.shape[0]
    R = row_edges.shape[0] - 1
    lo, hi = int(row_edges[0]), int(row_edges[-1])
    row = torch.repeat_interleave(torch.arange(R, device=dev),
                                  row_edges[1:] - row_edges[:-1],
                                  output_size=hi - lo)

    def call():
        terms, chc, _bot = _truth_terms(params, const, ph)
        idx = row * C + chc[lo:hi]
        x = (torch.stack([v[lo:hi] for v in terms], dim=1).to(torch.float64)
             * ph['valid'][lo:hi, None])
        acc = torch.zeros((R * C, len(terms)), dtype=torch.float64,
                          device=dev).index_add_(0, idx, x).reshape(R, C, -1)
        return tuple(acc[..., k].to(torch.int32) if k < 4
                     else acc[..., k].contiguous()
                     for k in range(len(PER_PMT_SUMS)))
    return call


def kernel_rows(dev, smi):
    """The rows ``ab_port.py --kernels`` compares between two checkouts:
    the superposition rows on every batch (superpose_measure), K17 on
    its three batches (window_rows_measure), the ZLE and
    record-pack rows on every grid (zle_pack_measure), K16 on 494 channels
    with its library computation (per_pmt_kernel_check), the K11 and K12b
    rows (ap_diffuse_measure), the K6 and K11-summaries rows
    (lumi_summaries_measure), the K8 row-truth and K16 rows
    (pmt_truth_measure), the K13a and K9 rows (photon_times_measure), the
    K14 rows (step_block_measure), the K13c rows (garfield_measure) and
    the K15 and K13b rows (s1_delays_measure)."""
    from wfsim_tpu_torch.config import default_config
    from wfsim_tpu_torch.interface import bench_instructions
    res = superpose_measure(dev, smi, max_syncs=None)
    res.update(window_rows_measure(dev, smi, max_syncs=None))
    res.update(zle_pack_measure(dev, smi, max_syncs=None))
    cfg = default_config(seed=1234, chunk_size=100, per_pmt_truth=True,
                         enable_noise=True, enable_pmt_afterpulses=True,
                         enable_electron_afterpulses=True)
    per_pmt_kernel_check(make_check(res, 'kernels-x', smi),
                         'pulse_truth_per_pmt', cfg,
                         bench_instructions(512, 2000, 300), dev)
    res.update(ap_diffuse_measure(dev, smi, max_syncs=None))
    res.update(lumi_summaries_measure(dev, smi, max_syncs=None))
    res.update(pmt_truth_measure(dev, smi, max_syncs=None))
    res.update(photon_times_measure(dev, smi, max_syncs=None))
    res.update(step_block_measure(dev, smi, max_syncs=None))
    res.update(garfield_measure(dev, smi, max_syncs=None))
    res.update(s1_delays_measure(dev, smi, max_syncs=None))
    return res


def phase_per_pmt_x1t(B, T, K, inst, dev, smi):
    """Phases 3g, 4g, 3h, 4h and 5h (see the module docstring); returns
    the measurements of the per-PMT rows (see make_check) and the launch
    counts of the 4g and 4h runs (phase 3j times the no-HE grid row)."""
    import torch
    from wfsim_tpu_torch import Simulator
    from wfsim_tpu_torch.config import default_config
    from wfsim_tpu_torch.models.params import build_params, build_constants
    from wfsim_tpu_torch.ops.waveform import (superpose_adc_full,
                                              superpose_adc_full_ref)
    from wfsim_tpu_torch.pipeline.digitize import (
        gather_digitize, pack_records, window_photons)
    from wfsim_tpu_torch.pipeline.rawdata import RawData
    from wfsim_tpu_torch.resources import load_config
    realism = dict(enable_noise=True, enable_pmt_afterpulses=True,
                   enable_electron_afterpulses=True)
    cfg_p = default_config(seed=1234, chunk_size=100, per_pmt_truth=True,
                           **realism)
    cfg_x = default_config(detector='XENON1T', seed=1234, chunk_size=100,
                           high_energy_deamplification_factor=1.0,
                           per_pmt_truth=True, **realism)
    n_ev = len(inst) // 2
    res = {}
    check = make_check(res, 'kernels-x', smi)

    # ---- 3g. K16 against its twin, XENONnT (494) and XENON1T (248) -------
    per_pmt_kernel_check(check, 'pulse_truth_per_pmt', cfg_p, inst, dev)
    per_pmt_kernel_check(check, 'pulse_truth_per_pmt_248', cfg_x, inst, dev)

    # ---- 4g. the per_pmt_truth main path -------------------------------
    out, wall, launches_p, peak, sim = timed_run(cfg_p, inst, dev)
    diag = sim.sim.rawdata.diag.summary()
    print(f'[per-pmt] launches {launches_p}')
    for name in PER_PMT_PATH_KERNELS:
        if launches_p[name] <= 0:
            raise AssertionError(f'kernel {name} not launched on the '
                                 f'per_pmt_truth path')
    off = Simulator(dict(cfg_p, per_pmt_truth=False),
                    device=dev).get_arrays(inst)
    truth = out['truth']
    n_top = cfg_p['n_top_pmts']
    n_type = {t: int((truth['type'] == t).sum()) for t in (1, 2, 4, 6)}
    if n_type[1] != n_ev or n_type[2] != n_ev or n_type[4] <= 0:
        raise AssertionError(f'per_pmt_truth truth rows by type {n_type}')
    if not strax_valid(out['raw_records'], cfg_p['n_tpc_pmts']):
        raise AssertionError('per_pmt_truth raw_records violate the strax '
                             'invariants')
    same = same_arrays({k: v for k, v in out.items() if k != 'truth'},
                       {k: v for k, v in off.items() if k != 'truth'})
    rel = check_per_pmt(truth, off['truth'], n_top, 'per_pmt_truth')
    print(f'[per-pmt] truth rows {len(truth)} by type {n_type}, vectors '
          f'{truth["n_photon_per_pmt"].shape}; records equal to the run '
          f'without per-PMT truth: {same}; per-PMT sums equal the totals '
          f'and the bottom fields (areas rel. diff. {rel:.3g})')
    if not same:
        raise AssertionError('per-PMT truth changed the records')
    expect_records('per_pmt_truth', len(out['raw_records']),
                   launches=launches_p)
    print(f'[per-pmt] events/s {n_ev / wall:.2f} wall {wall:.3f} s records '
          f'{len(out["raw_records"])} truth rows {len(truth)} peak_mem '
          f'{peak / 2 ** 20:.1f} MiB ({smi})')
    print(f'[per-pmt] phases {diag}')
    del out, off, truth

    # ---- 3h. the grid without HE rows against its twin -----------------
    const = build_constants(cfg_x)
    params = build_params(cfg_x, load_config(cfg_x), dev)
    C, R = const.n_tpc_pmts, const.n_channels_total
    tpc_r, tpc_l = cfg_x['tpc_radius'], cfg_x['tpc_length']
    r_max = float(np.hypot(inst['x'], inst['y']).max())
    z_lo, z_hi = float(inst['z'].min()), float(inst['z'].max())
    print(f'[x1t] {C} TPC channels ({const.n_top_pmts} top) in {R} rows, '
          f'factor {const.high_energy_deamp_int}; bench positions r <= '
          f'{r_max:.2f} cm, z in [{z_lo:.2f}, {z_hi:.2f}] cm inside the TPC '
          f'(radius {tpc_r} cm, length {tpc_l} cm)')
    if not (r_max <= tpc_r and -tpc_l <= z_lo and z_hi <= 0):
        raise AssertionError('bench positions outside the XENON1T TPC')
    rng = np.random.default_rng(20261016)
    t_np, ch_np, g_np, pieces = s2_like_arena(rng, B, C, T)
    ph = window_photons(const, *(torch.as_tensor(a, device=dev)
                                 for a in (t_np, ch_np, g_np)),
                        pieces, n_samples=T)
    sargs = (ph['t'], ph['gain'], ph['row_ptr'], params.templates,
             ph['ch_left'], ph['ch_right'], ph['has'])
    L = int(params.noise_bank.shape[1])
    nix = torch.as_tensor(L - T // 2 + np.arange(B) * 7, dtype=torch.int32,
                          device=dev)                         # all wrap
    fkw = dict(current_2_adc=const.current_2_adc,
               baseline=const.digitizer_reference_baseline, n_samples=T,
               n_channels=C, n_channels_total=R, n_top=const.n_top_pmts,
               he_start=None, sum_channel=None,
               deamp=const.high_energy_deamp_int,
               noise_bank=params.noise_bank, noise_ix=nix)
    grid = superpose_adc_full(*sargs, **fkw)
    err = max_diff(grid, superpose_adc_full_ref(*sargs, **fkw))
    print(f'[kernels-x] superpose_adc_full (no HE rows): {B} x {R} x {T}, '
          f'{len(t_np)} photons, noise_ix {nix[0].item()}.. of L={L}, '
          f'max|diff| {err}, TPC rows non-zero '
          f'{int((grid[:, :C] != 0).sum())}, rows past the TPC non-zero '
          f'{int((grid[:, C:] != 0).sum())}')
    if err or grid[:, C:].any() or not grid[:, :C].any():
        raise AssertionError('superpose_adc_full without HE rows differs '
                             'from its twin or writes past the TPC')
    del grid, ph, sargs

    # ---- 4h. the xenon1t_full_grid main path ---------------------------
    out, wall, launches_x, peak, sim = timed_run(cfg_x, inst, dev)
    diag = sim.sim.rawdata.diag.summary()
    print(f'[x1t] launches {launches_x}')
    for name in X1T_PATH_KERNELS:
        if launches_x[name] <= 0:
            raise AssertionError(f'kernel {name} not launched on the '
                                 f'xenon1t_full_grid path')
    if (launches_x['wfsim_superpose_adc_full'] != diag['digitize_calls']
            or launches_x['wfsim_superpose_adc']):
        raise AssertionError('not every XENON1T digitize batch ran the '
                             'grid without HE rows')
    rr, truth = out['raw_records'], out['truth']
    n_type = {t: int((truth['type'] == t).sum()) for t in (1, 2, 4, 6)}
    if sorted(out) != ['raw_records', 'truth'] or not strax_valid(rr, C):
        raise AssertionError('xenon1t_full_grid: a raw_records_he key, or '
                             'records off the 248 TPC channels')
    if n_type[1] != n_ev or n_type[2] != n_ev or n_type[4] <= 0:
        raise AssertionError(f'xenon1t_full_grid truth rows by type {n_type}')
    slim = Simulator(dict(cfg_x, split_digitize_gap_ns=0,
                          high_energy_deamplification_factor=0.05),
                     device=dev).get_arrays(inst)
    same = same_arrays(out, slim)
    off = Simulator(dict(cfg_x, per_pmt_truth=False),
                    device=dev).get_arrays(inst)
    rel = check_per_pmt(truth, off['truth'], const.n_top_pmts,
                        'xenon1t_full_grid')
    print(f'[x1t] records {len(rr)} (channels {int(rr["channel"].min())}-'
          f'{int(rr["channel"].max())}), keys {sorted(out)}; truth rows '
          f'{len(truth)} by type {n_type}, vectors '
          f'{truth["n_photon_per_pmt"].shape}; windows {diag["windows"]} in '
          f'{diag["digitize_calls"]} batches; records and truth equal to the '
          f'slim grid at the same framing (factor 0, split gap 0): {same}; '
          f'per-PMT sums (areas rel. diff. {rel:.3g})')
    if not same or off['raw_records'].tobytes() != rr.tobytes():
        raise AssertionError('XENON1T records differ between the grid '
                             'without HE rows and the slim grid, or with '
                             'per-PMT truth off')
    expect_records('xenon1t_full_grid', len(rr), launches=launches_x)
    print(f'[x1t] events/s {n_ev / wall:.2f} wall {wall:.3f} s records '
          f'{len(rr)} truth rows {len(truth)} peak_mem '
          f'{peak / 2 ** 20:.1f} MiB ({smi})')
    print(f'[x1t] phases {diag}')
    del out, slim, off

    # ---- 5h. one window batch without HE rows: card against CPU twins --
    rd = RawData(cfg_x, device=dev)
    rd.simulate(inst)
    _wins, arena_d, batches = rd.plan_digitize()
    cand = [b for b in batches if b[1] <= 4096] or batches
    batch, T_cap, pieces, nix_b = max(cand, key=lambda b: (b[1], len(b[0])))
    batch, pieces, nix_b = batch[:16], pieces[:16], nix_b[:16]
    recs = {}
    for d, ar in ((dev, arena_d), (torch.device('cpu'),
                                   [a.cpu() for a in arena_d])):
        prm = build_params(cfg_x, load_config(cfg_x), d)
        g = gather_digitize(prm, const, *ar, pieces,
                            torch.as_tensor(nix_b, device=d),
                            n_samples=T_cap, max_intervals=K)
        if tuple(g['data'].shape) != (len(batch), R, T_cap):
            raise AssertionError(f'grid {tuple(g["data"].shape)}')
        recs[d.type] = [x.cpu().numpy() for x in pack_records(
            g['data'], g['left_all'], g['starts'], g['ends'], g['counts'])]
    same = all(a.shape == b.shape and np.array_equal(a, b)
               for a, b in zip(recs['cuda'], recs['cpu']))
    print(f'[cross-x] windows {len(batch)} T_cap {T_cap} rows {R} records '
          f'{len(recs["cuda"][1])} cuda==cpu {same}')
    if not same or not len(recs['cuda'][1]):
        raise AssertionError('XENON1T digitize on the card differs from the '
                             'CPU twins (or has no record)')
    return res, launches_p, launches_x


def trim_host_heap():
    """Hand the heap's free pages back to the system (glibc
    ``malloc_trim``), so an RSS sample counts what the process holds, not
    the free pages its heap happens to keep (they move the samples by
    ~50-150 MiB from chunk to chunk); False where the C library has no
    such call."""
    import ctypes
    import ctypes.util
    try:
        ctypes.CDLL(ctypes.util.find_library('c')).malloc_trim(0)
        return True
    except (OSError, AttributeError, TypeError):
        return False


def rss_mib():
    """This process's resident set (VmRSS of /proc/self/status) in MiB,
    read after :func:`trim_host_heap`."""
    trim_host_heap()
    for line in Path('/proc/self/status').read_text().splitlines():
        if line.startswith('VmRSS:'):
            return int(line.split()[1]) / 1024
    raise RuntimeError('/proc/self/status has no VmRSS')


def stream_run(n_events, dev, smi):
    """One run of phase 4s (see the module docstring) on ``n_events``
    bench events; returns its measurements."""
    import gc
    import torch
    from wfsim_tpu_torch import Simulator, default_config
    from wfsim_tpu_torch.interface import bench_instructions
    inst = bench_instructions(n_events, 2000, 300)
    depth = -(-len(inst) // 1024)
    cfg = default_config(seed=1234, chunk_size=1, pipeline_depth=depth)
    sim = Simulator(cfg, device=dev)
    rd = sim.sim.rawdata
    arrival = rd._arrival_times(inst)
    sizes = [len(o) for o, _ in rd._split_super_batches(
        arrival, np.argsort(arrival, kind='stable'))]
    gc.collect()
    trimmed = trim_host_heap()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    held = torch.cuda.memory_allocated(dev) / 2 ** 20   # earlier phases'
    rss0 = rss_mib()
    rss_hw = rss0
    n_chunks = n_rec = n_truth = 0
    first = first_sb = None
    t0 = time.perf_counter()
    for chunk in sim.run(inst):
        if first is None:
            first = time.perf_counter() - t0
            first_sb = rd.diag.counts['super_batches']
        n_chunks += 1
        n_rec += len(chunk['raw_records'])
        n_truth += len(chunk['truth'])
        del chunk
        rss_hw = max(rss_hw, rss_mib())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 20
    m = dict(events=n_events, depth=depth, super_batches=len(sizes),
             batch_sizes=(min(sizes), max(sizes)),
             rounds=rd.diag.counts['rounds'], chunks=n_chunks,
             first_chunk_s=first, first_chunk_after_super_batches=first_sb,
             wall_s=wall, ev_s=n_events / wall, records=n_rec,
             peak_mib=peak, held_at_start_mib=held,
             run_peak_mib=peak - held, heap_trimmed=trimmed,
             rss_start_mib=rss0,
             rss_high_mib=rss_hw,
             rss_growth_mib=rss_hw - rss0)
    print(f'[stream] {n_events} events: {json.dumps(m)} ({smi})')
    if n_truth != len(inst):
        raise AssertionError(f'stream truth rows {n_truth} != {len(inst)}')
    if not first_sb < len(sizes):
        raise AssertionError('the first chunk came after the last '
                             'super-batch was simulated')
    return m


def phase_4s(dev, smi):
    """Phase 4s (see the module docstring); returns both runs'
    measurements."""
    short = stream_run(2_000, dev, smi)
    long = stream_run(10_000, dev, smi)
    # the peak counts the tensors earlier phases still hold; the run's own
    # peak is the part above them, and both ratios must hold
    peak_ratio = long['peak_mib'] / short['peak_mib']
    run_ratio = long['run_peak_mib'] / short['run_peak_mib']
    rss_ratio = long['rss_growth_mib'] / max(short['rss_growth_mib'], 1e-9)
    print(f'[stream] 10,000 / 2,000 events: device peak ratio '
          f'{peak_ratio:.4f}, above the tensors held before the runs '
          f'{run_ratio:.4f} (limit 1.10 for both), RSS growth ratio '
          f'{rss_ratio:.4f} (limit 1.25) ({smi})')
    if long['batch_sizes'] != short['batch_sizes']:
        print(f'[stream] super-batch sizes {long["batch_sizes"]} vs '
              f'{short["batch_sizes"]}')
    if max(peak_ratio, run_ratio) > 1.10 or rss_ratio > 1.25:
        raise AssertionError('memory grows with the run length')
    return short, long


#: the step's grid (samples) and instructions a shard in phases 3i / 4i
STEP_T = 2 ** 16
STEP_SHARD = 64
#: a rank process of phase 4i fails after this long (s)
RANK_LIMIT_S = 240


def digest(x):
    """sha256 of an array's (or tensor's) bytes, with its shape."""
    if not isinstance(x, np.ndarray):
        x = x.contiguous().cpu().numpy()
    return (x.shape, hashlib.sha256(x.tobytes()).hexdigest())


def arrays_digest(out):
    """The digest of every array of a ``get_arrays`` result."""
    return {k: digest(v) for k, v in sorted(out.items())}


def step_digests(adc, sum_signal, totals, n_ch, C):
    """Per local block b: the digest of each of ``n_ch`` channel blocks of
    ``adc[b]`` (the 1 x 1 grid cut as an n_ch-way step cuts it) and of the
    sum row; the totals as ints."""
    C_loc = -(-C // n_ch)
    return dict(adc=[[digest(adc[b, j * C_loc:(j + 1) * C_loc])
                      for j in range(n_ch)] for b in range(adc.shape[0])],
                sum=[digest(sum_signal[b]) for b in range(adc.shape[0])],
                totals=[int(v) for v in totals.tolist()])


def phase_3i(cfg, params, const, dev, smi):
    """Phase 3i (see the module docstring); returns the measurements of the
    superpose_block rows (see step_block_measure)."""
    import torch
    from wfsim_tpu_torch.interface import step_instructions
    from wfsim_tpu_torch.ops.waveform import (superpose_block,
                                              superpose_block_ref)
    from wfsim_tpu_torch.parallel.sharding import (
        block_photons, seeded_generator, simulate_block)
    C, n_top, dt = const.n_tpc_pmts, const.n_top_pmts, const.sample_duration
    inst = step_instructions(cfg, 1, STEP_SHARD, STEP_T)
    ph, totals = simulate_block(params, const, inst,
                                seeded_generator(1234, 0, dev))
    live = ph['valid'] & (ph['ch'] >= 0)
    in_grid = live & (ph['t'] >= 0) & (ph['t'] < STEP_T * dt)
    print(f'[kernels-m] step shard: {len(inst)} instructions, '
          f'{int(live.sum())} photons, in the {STEP_T}-sample grid '
          f'{int(in_grid.sum()) / int(live.sum()):.6f}; totals '
          f'{totals.tolist()}')
    block = torch.zeros(ph['t'].shape[0], dtype=torch.int64, device=dev)
    C_loc = -(-C // 2)
    for j in range(2):
        bp = block_photons(ph, block, n_blocks=1, ch_block=j * C_loc,
                           n_channels=C_loc, n_samples=STEP_T,
                           sample_duration=dt)
        args = (bp['t'], bp['gain'], bp['row_ptr'], params.templates)
        kw = dict(n_channels=C_loc, ch_block=j * C_loc, n_top=n_top,
                  n_tpc=C, current_2_adc=const.current_2_adc,
                  n_samples=STEP_T)
        out = superpose_block(*args, **kw)
        ref = superpose_block_ref(*args, **kw)
        err = max(max_diff(a, b) for a, b in zip(out, ref))
        print(f'[kernels-m] superpose_block: block {j} of 2 ({C_loc} x '
              f'{STEP_T}), {int(bp["t"].shape[0])} photons, differing '
              f'samples {int((out[0] != ref[0]).sum())}, sum row non-zero '
              f'{int((out[1] != 0).sum())}, max|diff| {err}')
        if err or not out[0].any():
            raise AssertionError('superpose_block differs from its twin '
                                 'or is empty')
        del out, ref, bp
    # one block of 494 (the 1 x 1 step's call) and its skewed copies
    return step_block_measure(dev, smi)


def run_step(cfg, n_ev, n_ch, dev):
    """The step at ``n_ev`` x ``n_ch`` on two shards of ``STEP_SHARD``
    instructions over this rank's mesh; returns (adc, sum, totals, step)."""
    from wfsim_tpu_torch.interface import step_instructions
    from wfsim_tpu_torch.models.params import build_params, build_constants
    from wfsim_tpu_torch.parallel import make_mesh, make_sharded_step
    from wfsim_tpu_torch.resources import load_config
    params = build_params(cfg, load_config(cfg), dev)
    const = build_constants(cfg)
    mesh = make_mesh(n_ev, n_ch)
    step = make_sharded_step(params, const, mesh, inst_per_shard=STEP_SHARD,
                             n_samples=STEP_T)
    inst = step_instructions(cfg, 2, STEP_SHARD, STEP_T)
    adc, sum_signal, totals = step(params, inst, 1234)
    return adc, sum_signal, totals, step


def mesh_rank(rank, world, init, out_path, steps, simulate, go):
    """One gloo rank of phase 4i(b) on cuda:0.  It starts its CUDA context
    and loads the kernels, waits for ``go``, then runs (with
    ``simulate``) the 512-event Simulator run over ``make_mesh(world,
    1)`` and the step at each ``(n_ev, n_ch)`` of ``steps``; pickles its
    results to ``out_path``."""
    sys.path.insert(0, str(ROOT))
    import torch
    import torch.distributed as dist
    from wfsim_tpu_torch import _build, default_config
    from wfsim_tpu_torch.interface import bench_instructions
    from wfsim_tpu_torch.parallel import make_mesh
    torch.cuda.set_device(0)
    dev = torch.device('cuda:0')
    torch.zeros(1, device=dev)
    _build.load_library()
    if not go.wait(RANK_LIMIT_S):
        raise SystemExit(f'rank {rank} of {world}: no start signal')
    dist.init_process_group(
        'gloo', init_method='file://' + init, rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=RANK_LIMIT_S // 2))
    res = {}
    try:
        cfg = default_config(seed=1234, chunk_size=100)
        if simulate:
            out, wall, launches, _peak, sim = timed_run(
                cfg, bench_instructions(512, 2000, 300), dev,
                lambda: make_mesh(world, 1), bench_instructions(16))
            res['simulator'] = dict(digest=arrays_digest(out), wall=wall,
                                    launches=launches,
                                    diag=sim.sim.rawdata.diag.summary(),
                                    records=len(out['raw_records']))
        for n_ev, n_ch in steps:
            adc, sum_signal, totals, step = run_step(cfg, n_ev, n_ch, dev)
            res[(n_ev, n_ch)] = dict(
                at=(step.ev_index, step.ch_block // step.C_loc),
                local=step_digests(adc, sum_signal, totals, 1, adc.shape[1]),
                all_reduces=step.all_reduces)
            del adc, sum_signal
    finally:
        dist.destroy_process_group()
    with open(out_path, 'wb') as f:
        pickle.dump(res, f)


class Ranks:
    """Phase 4i(b)'s ``world`` gloo rank processes on cuda:0, started
    (spawn) ahead of their turn: each prepares, then waits for
    :meth:`run`."""

    def __init__(self, world, tmp, steps, simulate):
        ctx = multiprocessing.get_context('spawn')
        self.world = world
        self.go = ctx.Event()
        init = str(Path(tmp) / f'gloo_init_{world}')
        self.outs = [str(Path(tmp) / f'rank_{world}_{r}.pkl')
                     for r in range(world)]
        self.procs = [ctx.Process(target=mesh_rank,
                                  args=(r, world, init, self.outs[r], steps,
                                        simulate, self.go))
                      for r in range(world)]
        for p in self.procs:
            p.start()

    def run(self):
        """Start the ranks' work and return each rank's results; raises
        when a rank exits non-zero or is still running after
        ``RANK_LIMIT_S`` (it is killed)."""
        t0 = time.perf_counter()
        self.go.set()
        deadline = time.monotonic() + RANK_LIMIT_S
        for p in self.procs:
            p.join(max(deadline - time.monotonic(), 0.0))
        late = self.stop()
        codes = [p.exitcode for p in self.procs]
        if late or codes != [0] * self.world:
            raise AssertionError(f'phase 4i: {self.world} gloo ranks, exit '
                                 f'codes {codes} ({late} killed after '
                                 f'{RANK_LIMIT_S} s)')
        res = []
        for path in self.outs:
            with open(path, 'rb') as f:
                res.append(pickle.load(f))
        return res, time.perf_counter() - t0

    def stop(self):
        """Kill the ranks still running; returns how many there were."""
        late = [p for p in self.procs if p.is_alive()]
        for p in late:
            p.kill()
            p.join(10)
        return len(late)


def check_step_ranks(ranks, n_ev, n_ch, ref, C):
    """Each rank's step blocks, sum rows and totals against the 1 x 1 run
    cut the same way, and only the sum rows and the totals all-reduced."""
    B = 2 // n_ev
    for out in (r[(n_ev, n_ch)] for r in ranks):
        e, j = out['at']
        loc = out['local']
        for b in range(B):
            if loc['adc'][b][0] != ref[n_ch]['adc'][e * B + b][j]:
                raise AssertionError(f'step {n_ev} x {n_ch}: block {e * B + b}'
                                     f', channels {j} differ from 1 x 1')
            if loc['sum'][b] != ref[n_ch]['sum'][e * B + b]:
                raise AssertionError(f'step {n_ev} x {n_ch}: sum row differs')
        if loc['totals'] != ref[n_ch]['totals']:
            raise AssertionError(f'step {n_ev} x {n_ch}: totals differ')
        if out['all_reduces'] != [('channels', B * STEP_T * 4),
                                  ('events', 16)]:
            raise AssertionError(f'step all_reduces {out["all_reduces"]}')
    print(f'[mesh] step {n_ev} x {n_ch} ({len(ranks)} gloo ranks on '
          f'cuda:0): every block, sum row and the totals equal to 1 x 1; '
          f'all_reduce bytes per rank {ranks[0][(n_ev, n_ch)]["all_reduces"]}')


def phase_4i(cfg, inst, main_digest, dev, smi):
    """Phase 4i (see the module docstring); returns the launch counts of
    the 1 x 1 step run."""
    import torch
    import torch.distributed as dist
    from wfsim_tpu_torch import _build
    from wfsim_tpu_torch.interface import bench_instructions, step_instructions
    from wfsim_tpu_torch.models.params import build_params
    from wfsim_tpu_torch.parallel import make_mesh
    from wfsim_tpu_torch.resources import load_config
    n_ev = len(inst) // 2
    C, n_top = cfg['n_tpc_pmts'], cfg['n_top_pmts']
    tmp = tempfile.mkdtemp(prefix='wfsim_smoke_mesh_')
    groups = []
    try:
        # the gloo ranks of (b) start now and wait for their turn
        groups = [Ranks(2, tmp, [(2, 1), (1, 2)], True),
                  Ranks(4, tmp, [(2, 2)], False)]

        # ---- (a) NCCL at world size 1 -------------------------------------
        dist.init_process_group(
            'nccl', init_method='file://' + str(Path(tmp) / 'nccl_init'),
            rank=0, world_size=1,
            timeout=datetime.timedelta(seconds=RANK_LIMIT_S // 2))
        try:
            torch.cuda.synchronize()
            for k in _build.KERNELS.values():
                k.launches = 0
            adc, sum_signal, totals, step = run_step(cfg, 1, 1, dev)
            torch.cuda.synchronize()
            launches = {name: k.launches for name, k in
                        _build.KERNELS.items()}
            bottom = adc[:, n_top:C].sum(dim=1, dtype=torch.int32)
            n_photon, n_pe = totals.tolist()
            print(f'[mesh] step 1 x 1 (NCCL): grid {tuple(adc.shape)} int32, '
                  f'non-zero samples {int((adc != 0).sum())}, totals '
                  f'[n_photon {n_photon}, n_pe {n_pe}], superpose_block '
                  f'launches {launches["wfsim_superpose_block"]}, '
                  f'all_reduces {step.all_reduces}')
            if (launches['wfsim_superpose_block'] <= 0
                    or not torch.equal(bottom, sum_signal)
                    or not n_pe >= n_photon > 0):
                raise AssertionError('step 1 x 1: kernel not launched, sum '
                                     'row off the bottom channels, or no '
                                     'photons')
            ref = {n_ch: step_digests(adc, sum_signal, totals, n_ch, C)
                   for n_ch in (1, 2)}
            del adc, sum_signal, bottom
            # the step's wall: three more calls, each ended by a sync
            params = build_params(cfg, load_config(cfg), dev)
            step_inst = step_instructions(cfg, 2, STEP_SHARD, STEP_T)
            walls = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                step(params, step_inst, 1234)
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
            wall = statistics.median(walls)
            print(f'[mesh] step 1 x 1 (NCCL) wall {wall:.4f} s a call '
                  f'(median of {[round(w, 4) for w in walls]}; two blocks '
                  f'of {STEP_SHARD} instructions, {STEP_T} samples) ({smi})')
            out, wall, _l, _peak, sim = timed_run(
                cfg, inst, dev, lambda: make_mesh(1, 1),
                bench_instructions(16))
            diag = sim.sim.rawdata.diag.summary()
            same = arrays_digest(out) == main_digest
            print(f'[mesh] Simulator over make_mesh(1, 1) (NCCL): records '
                  f'{len(out["raw_records"])}, equal to the mesh=None run: '
                  f'{same}; events/s {n_ev / wall:.2f} wall {wall:.3f} s, '
                  f'broadcast {diag.get("broadcast_bytes", 0)} bytes ({smi})')
            if not same:
                raise AssertionError('the NCCL mesh run differs from the '
                                     'single-device run')
            del out
        finally:
            dist.destroy_process_group()

        # ---- (b) gloo, 2 then 4 ranks sharing cuda:0 ----------------------
        ranks, t_2 = groups[0].run()
        total = {}
        for r, res in enumerate(ranks):
            sim = res['simulator']
            if sim['digest'] != main_digest:
                raise AssertionError(f'gloo rank {r} of 2: records or truth '
                                     f'differ from the mesh=None run')
            for name, n in sim['launches'].items():
                total[name] = total.get(name, 0) + n
            print(f'[mesh] Simulator over make_mesh(2, 1), gloo rank {r} of '
                  f'2 on cuda:0: records {sim["records"]} bitwise the '
                  f'mesh=None run; events/s {n_ev / sim["wall"]:.2f} wall '
                  f'{sim["wall"]:.3f} s, broadcast '
                  f'{sim["diag"].get("broadcast_bytes", 0)} bytes, '
                  f'broadcast_s {sim["diag"].get("broadcast_s")} ({smi})')
        missing = [k for k in DEFAULT_PATH_KERNELS if total.get(k, 0) <= 0]
        print(f'[mesh] launches across the 2 ranks {total}')
        if missing:
            raise AssertionError(f'not launched across the ranks: {missing}')
        for shape in ((2, 1), (1, 2)):
            check_step_ranks(ranks, *shape, ref, C)
        ranks4, t_4 = groups[1].run()
        check_step_ranks(ranks4, 2, 2, ref, C)
        print(f'[mesh] from their start signal 2 ranks took {t_2:.1f} s, 4 '
              f'ranks {t_4:.1f} s; ranks that share one card are no speedup '
              f'(NCCL across two cards not exercised: one card)')
    finally:
        for g in groups:
            g.stop()
        shutil.rmtree(tmp, ignore_errors=True)
    return launches


def optical_inputs(name, seed=1234):
    """A configuration of OPTICAL_CONFIGS and its photon list: the port's
    ``read_optical`` on the synthetic GEANT4 tree (``synthetic_g4_file``,
    its ``uproot`` a stub that returns it; for the nVeto a flat 30 % QE
    over 300-600 nm), the events then OPTICAL_SPACING_NS apart.  Returns
    (cfg, instructions, channels, timings, host seconds of the read)."""
    import types
    from wfsim_tpu_torch import default_config
    from wfsim_tpu_torch.interface import read_optical
    from wfsim_tpu_torch.resources.synthetic import (synthetic_g4_file,
                                                     synthetic_nv_pmt_qe)
    spec = OPTICAL_CONFIGS[name]
    g4 = synthetic_g4_file(OPTICAL_EVENTS, seed,
                           first_channel=spec['first_channel'],
                           n_channels=spec['n_channels'],
                           mean_hits=spec['mean_hits'], tau_ns=spec['tau_ns'])
    cfg = default_config(detector=spec['detector'], seed=seed, chunk_size=100,
                         **spec['overrides'])
    cfg['fax_file'] = f'synthetic_{name}.root'
    if spec['detector'] == 'XENONnT_neutron_veto':
        cfg['nv_pmt_qe'] = synthetic_nv_pmt_qe(
            range(spec['first_channel'],
                  spec['first_channel'] + spec['n_channels']))
    saved = sys.modules.get('uproot')
    sys.modules['uproot'] = types.SimpleNamespace(open=lambda path: g4)
    try:
        t0 = time.perf_counter()
        ins, ch, t = read_optical(cfg)
        t_read = time.perf_counter() - t0
    finally:
        if saved is None:
            sys.modules.pop('uproot')
        else:
            sys.modules['uproot'] = saved
    ins['time'] += (ins['g4id'].astype(np.int64) + 1) * OPTICAL_SPACING_NS
    return cfg, ins, ch, t, t_read


def optical_card_vs_cpu(cfg, ins, ch, t, dev, smi, tag):
    """The first simulation batch's optical response on the card and, from
    the same draws, through the twins on the CPU: photons bitwise, truth
    exact or (float64 sums) rtol 1e-12."""
    import torch
    from wfsim_tpu_torch.models.params import build_params
    from wfsim_tpu_torch.models.pmt import pmt_draws
    from wfsim_tpu_torch.pipeline.optical import (RawDataOptical,
                                                  optical_response)
    from wfsim_tpu_torch.resources import load_config
    rd = RawDataOptical(cfg, ch, t, device=dev)
    order = np.argsort(rd._arrival_times(ins), kind='stable')
    kind, idx = rd._sim_batch_list(ins, order)[0]
    tt, cc, counts = rd.batch_photons(ins, idx)
    gen = torch.Generator(device=dev)
    gen.manual_seed(20261016)
    draws = pmt_draws(gen, len(tt), dev)
    counts = torch.from_numpy(counts)
    params_c = build_params(cfg, load_config(cfg), 'cpu')
    out = {}
    for d, prm in ((dev, rd.params), (torch.device('cpu'), params_c)):
        t0 = time.perf_counter()
        out[d.type] = optical_response(
            prm, rd.const, torch.as_tensor(tt, device=d),
            torch.as_tensor(cc, device=d), counts, to_device(draws, d))
        if d.type == 'cuda':
            torch.cuda.synchronize()
        out[d.type + '_s'] = time.perf_counter() - t0
    compare(out['cuda'][0], out['cpu'][0], f'{tag} photons card vs CPU')
    err = compare(out['cuda'][1], out['cpu'][1], f'{tag} truth card vs CPU',
                  FLOAT_TRUTH + PER_PMT_AREAS)
    print(f'[{tag}] {kind} batch of {len(idx)} instructions, photons '
          f'{len(tt)}: photons bitwise equal, truth max|diff| {err} (card '
          f'{out["cuda_s"]:.3f} s, CPU twins {out["cpu_s"]:.3f} s; {smi})')


def phase_optical(dev, smi):
    """Phases 4r and 5r for each configuration of OPTICAL_CONFIGS (see the
    module docstring); returns {configuration: launch counts}."""
    import torch
    from wfsim_tpu_torch import _build
    from wfsim_tpu_torch.dtypes import concat_records
    from wfsim_tpu_torch.pipeline.chunker import ChunkRawRecords
    from wfsim_tpu_torch.pipeline.optical import (NVETO_TIME_MAX_CUTOFF,
                                                  RawDataOptical,
                                                  optical_photons)
    launches_by = {}
    for name, spec in OPTICAL_CONFIGS.items():
        tag = name.replace('optical_', 'opt-')
        cfg, ins, ch, t, t_read = optical_inputs(name)
        kept = optical_photons(ins, t, ch, 0, NVETO_TIME_MAX_CUTOFF)[2]
        n_split = len(ins) - OPTICAL_EVENTS
        print(f'[{tag}] read_optical: {len(ins)} instructions ({n_split} '
              f'split off events with hits past 1 us), photons {len(ch)} '
              f'kept {int(kept.sum())}, channels {int(ch.min())}-'
              f'{int(ch.max())}, {t_read:.3f} s on the host')

        def run():
            sim = ChunkRawRecords(cfg, device=dev,
                                  rawdata_generator=RawDataOptical,
                                  channels=ch, timings=t)
            torch.cuda.synchronize()
            for k in _build.KERNELS.values():
                k.launches = 0
            zero_second_pass()
            torch.cuda.reset_peak_memory_stats(dev)
            t0 = time.perf_counter()
            outs = list(sim(ins))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = {n: k.launches for n, k in _build.KERNELS.items()}
            rr = concat_records([o['raw_records'] for o in outs])
            truth = np.concatenate([o['truth'] for o in outs])
            return rr, truth, wall, launches, sim
        run()                                             # warm-up
        rr, truth, wall, launches, sim = run()
        peak = torch.cuda.max_memory_allocated(dev)
        launches_by[name] = launches
        print(f'[{tag}] launches {launches}')
        for k in spec['kernels']:
            if launches[k] <= 0:
                raise AssertionError(f'kernel {k} not launched on the {name} '
                                     f'path')
        n_ch = spec['n_channels']
        if len(truth) != len(ins) or set(truth['type'].tolist()) != {1}:
            raise AssertionError(f'{name}: truth rows {len(truth)} of '
                                 f'{len(ins)} instructions')
        if not strax_valid(rr, n_ch):
            raise AssertionError(f'{name} raw_records violate the strax '
                                 f'invariants (channels below {n_ch})')

        def pairs(g4id, n):
            return sorted(zip(g4id.tolist(), n.tolist()))
        if pairs(truth['g4id'], truth['n_photon']) != pairs(ins['g4id'], kept):
            raise AssertionError(f'{name}: n_photon of the truth rows differs '
                                 f'from the photons each instruction keeps')
        diag = sim.rawdata.diag.summary()
        ap = diag.get('pmt_ap_photons', 0)
        print(f'[{tag}] truth rows {len(truth)} (n_photon = kept photons), '
              f'records {len(rr)} on channels {int(rr["channel"].min())}-'
              f'{int(rr["channel"].max())}, afterpulse photons {ap}')
        expect_records(name, len(rr), launches=launches)
        print(f'[{tag}] events/s {OPTICAL_EVENTS / wall:.2f} wall '
              f'{wall:.3f} s records {len(rr)} photons '
              f'{int(truth["n_photon"].sum())} peak_mem '
              f'{peak / 2 ** 20:.1f} MiB ({smi})')
        print(f'[{tag}] phases {diag}')
        optical_card_vs_cpu(cfg, ins, ch, t, dev, smi, tag)
    return launches_by


def phase_legacy_pulses(dev, smi):
    """Phase 4t: the legacy pulse generator ``RawData.__call__`` over one
    super-batch of the default configuration (60 bench events, under
    ``2 * pipeline_min_batch`` instructions): its pulses, cut back into
    records, are the records of the same run through ``iter_windows``."""
    from wfsim_tpu_torch import default_config
    from wfsim_tpu_torch.interface import bench_instructions
    from wfsim_tpu_torch.pipeline.rawdata import RawData
    cfg = default_config(seed=1234, chunk_size=100)
    inst = bench_instructions(60, 2000, 300)
    rd = RawData(cfg, device=dev)
    recs = [w['records'] for w in rd.iter_windows(inst)]
    super_batches = rd.diag.counts['super_batches']
    recs = np.concatenate(recs)
    rd = RawData(cfg, device=dev)
    t0 = time.perf_counter()
    pulses, events = [], set()
    for p in rd(inst, []):
        pulses.append(p)
        events.add(rd.instruction_event_number)
    wall = time.perf_counter() - t0
    rebuilt = []
    for ch, left, right, data in pulses:
        n = right - left + 1
        for i in range(-(-n // 110)):
            seg = data[110 * i:110 * (i + 1)]
            rebuilt.append((ch, (left + 110 * i) * 10, len(seg), n, i,
                            np.pad(seg, (0, 110 - len(seg))).tobytes()))
    want = [(int(r['channel']), int(r['time']), int(r['length']),
             int(r['pulse_length']), int(r['record_i']), r['data'].tobytes())
            for r in recs]
    same = sorted(rebuilt) == sorted(want)
    print(f'[legacy] super-batches {super_batches}, records {len(recs)}, '
          f'pulses {len(pulses)} over {len(events)} event numbers, '
          f'reassembled records equal {same} ({wall:.3f} s; {smi})')
    if super_batches != 1 or not same or not len(recs):
        raise AssertionError('the legacy pulses do not reassemble the '
                             'records of one super-batch')


def phase_gaps(realistic_digest, dev, smi):
    """Phase 4v (see the module docstring): unknown instruction types on
    the default run, resource names found nowhere on the realistic run."""
    import os
    from wfsim_tpu_torch import default_config
    from wfsim_tpu_torch.interface import bench_instructions
    inst = bench_instructions(512, 2000, 300)
    s1 = inst[inst['type'] == 1]
    extra = np.repeat(s1, 4)
    extra['type'] = np.tile([0, 3, 5, 7], len(s1))
    mixed = np.concatenate([inst, extra])
    cfg = default_config(seed=1234, chunk_size=100)
    out, wall, launches, _peak, _sim = timed_run(cfg, mixed, dev)
    rr, truth = out['raw_records'], out['truth']
    n_type = {int(t): int((truth['type'] == t).sum())
              for t in np.unique(truth['type'])}
    print(f'[gaps] default + {len(extra)} instructions of types 0, 3, 5, 7: '
          f'truth rows by type {n_type}, records {len(rr)}, wall {wall:.3f} '
          f's, events/s {512 / wall:.2f} ({smi})')
    if n_type != {1: 512, 2: 512}:
        raise AssertionError(f'unknown types: truth rows by type {n_type}')
    expect_records('default', len(rr), launches=launches,
                   digest=run_digest(out))

    os.environ.pop('WFSIM_TPU_ALLOW_DOWNLOAD', None)
    empty = tempfile.mkdtemp(prefix='wfsim_smoke_nowhere_')
    try:
        names = dict(noise_file='noise_nowhere.npz',
                     photon_ap_cdfs='pmt_ap_nowhere.json.gz',
                     photon_area_distribution='spe_nowhere.csv',
                     ele_ap_pdfs='ele_ap_nowhere.pkl')
        cfg_r = default_config(seed=1234, chunk_size=100, enable_noise=True,
                               enable_pmt_afterpulses=True,
                               enable_electron_afterpulses=True,
                               url_base=empty, **names)
        out, wall, launches, _peak, _sim = timed_run(cfg_r, inst, dev)
    finally:
        shutil.rmtree(empty, ignore_errors=True)
    rr = out['raw_records']
    digest = run_digest(out)
    print(f'[gaps] realistic with {sorted(names)} found nowhere: records '
          f'{len(rr)}, digest {digest} (phase 4b: {realistic_digest}), wall '
          f'{wall:.3f} s, events/s {512 / wall:.2f} ({smi})')
    expect_records('realistic', len(rr), launches=launches)
    if digest != realistic_digest:
        raise AssertionError('realistic run with resource names found '
                             'nowhere differs from phase 4b\'s')


def main():
    t_start = time.perf_counter()
    if not (ROOT / 'wfsim_tpu_torch' / '_build.py').exists():
        raise SystemExit('chip_smoke.py runs from the root of a wfsim_tpu '
                         'checkout (wfsim_tpu_torch/ not found)')
    sys.path.insert(0, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        raise SystemExit('no CUDA device: chip_smoke.py needs an NVIDIA GPU')

    # ---- 1. device -----------------------------------------------------
    smi = sh(['nvidia-smi', '--query-gpu=name,power.limit',
              '--format=csv,noheader']).splitlines()[0]
    dev = torch.device('cuda:0')
    kind = torch.cuda.get_device_name(0)
    print(f'[device] {smi}')
    print(f'[device] torch {torch.__version__} cuda {torch.version.cuda} '
          f'python {sys.version.split()[0]}')
    from wfsim_tpu_torch import _build
    nvcc_ver = sh([_build._nvcc(), '--version']).splitlines()[-1]
    print(f'[device] {nvcc_ver}')

    # ---- 2. build --------------------------------------------------------
    info = _build.build(ptxas_verbose=True)
    print(f'[build] {info["path"]} built={info["built"]} '
          f'seconds={info["seconds"]:.2f}')
    for line in info['log'].splitlines():
        if 'Used' in line or 'Compiling entry' in line:
            print(f'[build] {line.strip()}')
    print(f'[build] stream_of (the launch stream of every wrapper): '
          f'{host_us(lambda: _build.stream_of(dev), calls=10_000):.3f} us a '
          f'call ({smi})')

    from wfsim_tpu_torch import default_config
    from wfsim_tpu_torch.interface import bench_instructions
    from wfsim_tpu_torch.models.params import build_params, build_constants
    from wfsim_tpu_torch.resources import load_config
    from wfsim_tpu_torch.ops.waveform import superpose_adc, superpose_adc_ref
    from wfsim_tpu_torch.ops.zle import zle_all_channels, zle_all_channels_ref
    from wfsim_tpu_torch.pipeline.digitize import (
        window_photons, gather_digitize, pack_records, pack_records_ref)
    from wfsim_tpu_torch.pipeline.rawdata import RawData

    # ---- 3. kernels against their twins on the card -----------------------
    cfg = default_config(seed=1234, chunk_size=100)
    const = build_constants(cfg)
    params = build_params(cfg, load_config(cfg), dev)
    B, C, T, K = 16, const.n_tpc_pmts, 2048, 64
    rng = np.random.default_rng(20261016)
    t_np, ch_np, g_np, pieces = s2_like_arena(rng, B, C, T)
    arena = [torch.as_tensor(a, device=dev) for a in (t_np, ch_np, g_np)]
    ph = window_photons(const, *arena, pieces, n_samples=T)
    print(f'[kernels] B={B} rows={B * C} T={T} photons={len(t_np)}')
    sargs = (ph['t'], ph['gain'], ph['row_ptr'], params.templates,
             ph['ch_left'], ph['ch_right'], ph['has'])
    skw = dict(current_2_adc=const.current_2_adc,
               baseline=const.digitizer_reference_baseline, n_samples=T)
    grid = superpose_adc(*sargs, **skw)
    grid_ref = superpose_adc_ref(*sargs, **skw)
    diff = (grid.to(torch.int32) - grid_ref.to(torch.int32)).abs()
    n_tie = int((diff > 0).sum())
    err1 = int(diff.max())
    print(f'[kernels] superpose_adc: tie samples {n_tie}, max|diff| {err1}, '
          f'samples below baseline in windows '
          f'{int(((grid_ref > 0) & (grid_ref < 16000)).sum())}')
    if n_tie:
        raise AssertionError('superpose_adc differs from its twin')

    zthr = params.zle_thresholds[:C].repeat(B).contiguous()
    zargs = (grid, zthr, ph['ch_left'], ph['ch_right'], ph['has'])
    zkw = dict(holdoff=2 * const.trigger_window + 1,
               trigger_window=const.trigger_window, max_intervals=K)
    zk = zle_all_channels(*zargs, **zkw)
    zr = zle_all_channels_ref(*zargs, **zkw)
    err2 = max(int((a - b).abs().max()) for a, b in zip(zk, zr))
    print(f'[kernels] zle_intervals: intervals {int(zr[2].sum())}, '
          f'max|diff| {err2}')
    if err2:
        raise AssertionError('zle_intervals differs from its twin')

    pargs = (grid.reshape(B, C, T), ph['ch_left'].reshape(B, C),
             zk[0].reshape(B, C, K), zk[1].reshape(B, C, K),
             zk[2].reshape(B, C))
    pk = pack_records(*pargs)
    pr = pack_records_ref(*pargs)
    if pk[0].shape != pr[0].shape or pk[1].shape != pr[1].shape:
        raise AssertionError(f'pack_records shapes {pk[0].shape} vs '
                             f'{pr[0].shape}')
    err3 = max(int((pk[0].to(torch.int32) - pr[0].to(torch.int32)).abs().max()),
               int((pk[1] - pr[1]).abs().max()))
    print(f'[kernels] pack_records: records {pk[0].shape[0]}, max|diff| {err3}')
    if err3:
        raise AssertionError('pack_records differs from its twin')

    # ---- 4. main path ------------------------------------------------------
    inst = bench_instructions(512, 2000, 300)
    out, wall, launches, peak, sim = timed_run(cfg, inst, dev)
    rr, truth = out['raw_records'], out['truth']
    print(f'[main] launches {launches}')
    for name in DEFAULT_PATH_KERNELS:
        if launches[name] <= 0:
            raise AssertionError(f'kernel {name} not launched on the main path')
    if len(truth) != len(inst):
        raise AssertionError(f'truth rows {len(truth)} != {len(inst)}')
    if not strax_valid(rr, C):
        raise AssertionError('raw_records violate the strax invariants')
    s1 = truth[truth['type'] == 1]
    s2 = truth[truth['type'] == 2]
    ly = C * 14e-5 / (1 + cfg['p_double_pe_emision']) \
        * cfg['s1_detection_efficiency']
    expect = 2000 * ly
    if not np.all(np.abs(s1['n_photon'] - expect) < 6 * np.sqrt(expect) + 5):
        raise AssertionError('S1 photon counts off the binomial expectation')
    drift = -s2['z'] / cfg['drift_velocity_liquid'] + cfg['drift_time_gate']
    expect_e = 300 * np.exp(-drift / cfg['electron_lifetime_liquid'])
    if not np.all(np.abs(s2['n_electron'] - expect_e)
                  < 6 * np.sqrt(expect_e) + 5):
        raise AssertionError('S2 electron counts off the lifetime expectation')
    n_photons = int(truth['n_photon'].sum())
    print(f'[main] events/s {512 / wall:.2f} wall {wall:.3f} s records '
          f'{len(rr)} photons {n_photons} peak_mem '
          f'{peak / 2 ** 20:.1f} MiB ({smi})')
    print(f'[main] phases {sim.sim.rawdata.diag.summary()}')
    print(f'[main] physics phases {physics_phases(sim)}')
    main_digest = arrays_digest(out)
    expect_records('default', len(rr), launches=launches,
                   digest=run_digest(out))
    from wfsim_tpu_torch import Simulator
    busy = device_busy(lambda: Simulator(cfg, device=dev).get_arrays(inst))
    print(f'[main] device busy share {busy["share"]:.4f} of a warm run\'s '
          f'{busy["wall_s"]:.3f} s (median of 3 runs; '
          f'{busy["share_profiled"]:.4f} of the profiled run\'s '
          f'{busy["wall_profiled_s"]:.3f} s): device '
          f'busy {busy["busy_s"]:.4f} s, copies {busy["copy_s"]:.4f} s, '
          f'{busy["records"]} device records ({smi})')

    # ---- 5. one window batch: card against the CPU twins -------------------
    rd = RawData(cfg, device=dev)
    rd.simulate(inst)
    wins, arena_d, batches = rd.plan_digitize()
    batch, T_cap, pieces, _nix = max(batches,
                                     key=lambda b: (b[1], len(b[0])))
    arena_c = [a.cpu() for a in arena_d]
    res = {}
    for name, d, ar in (('cuda', dev, arena_d), ('cpu', torch.device('cpu'),
                                                 arena_c)):
        prm = build_params(cfg, load_config(cfg), d)
        g = gather_digitize(prm, const, *ar, pieces,
                            n_samples=T_cap, max_intervals=K)
        rec = pack_records(g['data'], g['left_all'], g['starts'], g['ends'],
                           g['counts'])
        res[name] = [x.cpu().numpy() for x in rec]
    same = all(np.array_equal(a, b) for a, b in zip(res['cuda'], res['cpu']))
    print(f'[cross] windows {len(batch)} T_cap {T_cap} records '
          f'{len(res["cuda"][0])} cuda==cpu {same}')
    if not same:
        raise AssertionError('digitize on the card differs from the CPU twins')

    # ---- 3b. realistic-config kernels against their twins -----------------
    from wfsim_tpu_torch.models.afterpulse import (
        pmt_ap_draws, pmt_afterpulse_photons, pmt_afterpulse_photons_ref,
        summary_draws, photon_summaries, photon_summaries_ref)
    cfg_r = default_config(seed=1234, chunk_size=100, enable_noise=True,
                           enable_pmt_afterpulses=True,
                           enable_electron_afterpulses=True)
    params_r = build_params(cfg_r, load_config(cfg_r), dev)
    const_r = build_constants(cfg_r)        # after build_params (AP metadata)
    gen = torch.Generator(device=dev)
    gen.manual_seed(20261016)
    n_ph, n_rows = 1_500_000, 512
    ph_ap = s2_like_photons(rng, n_ph, C, n_rows, dev)
    E = int(params_r.pmt_ap_delay_cdf.shape[0])
    draws = pmt_ap_draws(gen, E, n_ph, dev)
    ap_k, info_k = pmt_afterpulse_photons(params_r, const_r, ph_ap, draws,
                                          n_truth_rows=n_rows)
    ap_r, info_r = pmt_afterpulse_photons_ref(params_r, const_r, ph_ap, draws,
                                              n_truth_rows=n_rows)
    if info_k['total'] != info_r['total']:
        raise AssertionError(f'afterpulse totals {info_k["total"]} vs '
                             f'{info_r["total"]}')
    err4 = max([max_diff(ap_k[k], ap_r[k]) for k in ap_k]
               + [max_diff(info_k[k], info_r[k])
                  for k in ('counts', 't_min', 't_max')])
    print(f'[kernels-r] pmt_afterpulse: photons {n_ph} elements {E} '
          f'selected {info_k["total"]} ({info_k["total"] / n_ph:.4f} per '
          f'photon), max|diff| {err4}')
    if err4:
        raise AssertionError('pmt_afterpulse differs from its twin')
    u_s = summary_draws(gen, n_rows, dev)
    sk, sr = (f(ph_ap, u_s, n_inst=n_rows)
              for f in (photon_summaries, photon_summaries_ref))
    err5 = max(max_diff(a, b) for a, b in zip(sk, sr))
    print(f'[kernels-r] ap_photon_summaries: instructions {n_rows} '
          f'candidates {u_s.shape[1]}, max|diff| {err5} (3m times it)')
    if err5:
        raise AssertionError('ap_photon_summaries differs from its twin')
    L_noise = int(params_r.noise_bank.shape[1])
    nix = torch.as_tensor(L_noise - T // 2 + np.arange(B) * 7,
                          dtype=torch.int32, device=dev)  # all wrap the bank
    nkw = dict(skw, noise_bank=params_r.noise_bank, noise_ix=nix,
               n_channels=C)
    grid_n = superpose_adc(*sargs, **nkw)
    grid_nr = superpose_adc_ref(*sargs, **nkw)
    err6 = max_diff(grid_n, grid_nr)
    in_win = grid_nr[(grid_nr > 15900) & (grid_nr < 16100)].to(torch.float32)
    print(f'[kernels-r] superpose_adc+noise: noise_ix {nix[0].item()}.. of '
          f'L={L_noise}, differing samples {int((grid_n != grid_nr).sum())}, '
          f'max|diff| {err6}, quiet in-window std {in_win.std().item():.3f}')
    if err6 or not in_win.std().item() > 0.5:
        raise AssertionError('superpose_adc with noise differs from its twin '
                             'or shows no noise')
    del ph_ap, draws, ap_k, ap_r, grid_n, grid_nr

    # ---- 4b. realistic main path -----------------------------------------
    out, wall_r, launches_r, peak_r, sim = timed_run(cfg_r, inst, dev)
    rr, truth = out['raw_records'], out['truth']
    diag = sim.sim.rawdata.diag.summary()
    print(f'[realistic] launches {launches_r}')
    for name in REALISTIC_PATH_KERNELS:
        if launches_r[name] <= 0:
            raise AssertionError(f'kernel {name} not launched on the '
                                 f'realistic path')
    n_type = {t: int((truth['type'] == t).sum()) for t in (1, 2, 4, 6)}
    if n_type[1] != 512 or n_type[2] != 512 or n_type[4] <= 0:
        raise AssertionError(f'truth rows by type {n_type}')
    n_photons = int(truth['n_photon'].sum())
    ap_frac = diag['pmt_ap_photons'] / n_photons
    if not 0.012 < ap_frac < 0.05:
        raise AssertionError(f'afterpulse photon fraction {ap_frac}')
    if not strax_valid(rr, C):
        raise AssertionError('realistic raw_records violate the strax '
                             'invariants')
    j = np.arange(110)[None, :]
    inside = rr['data'][j < rr['length'][:, None]].astype(np.float64)
    quiet = inside[np.abs(inside - 16000) < 30]
    print(f'[realistic] truth rows by type {n_type}, afterpulse photons '
          f'{diag["pmt_ap_photons"]} of {n_photons} ({ap_frac:.4f}), quiet '
          f'samples mean {quiet.mean():.3f} std {quiet.std():.3f}')
    if not (15900 < quiet.mean() < 16100 and quiet.std() > 0.5):
        raise AssertionError('no noise on quiet in-window samples')
    expect_records('realistic', len(rr), launches=launches_r)
    realistic_digest = run_digest(out)
    print(f'[realistic] events/s {512 / wall_r:.2f} wall {wall_r:.3f} s '
          f'records {len(rr)} photons {n_photons} peak_mem '
          f'{peak_r / 2 ** 20:.1f} MiB ({smi})')
    print(f'[realistic] phases {diag}')
    print(f'[realistic] physics phases {physics_phases(sim)}')

    # ---- 5b. one realistic window batch: card against the CPU twins -------
    rd = RawData(cfg_r, device=dev)
    rd.simulate(inst)
    wins, arena_d, batches = rd.plan_digitize()
    # the batch with the most pieces beyond one per window (afterpulse
    # pulses join their S2's window as pieces of their own), cut to its 16
    # windows with the most pieces so the CPU twins stay quick
    batch, T_cap, pieces, nix = max(
        batches, key=lambda b: int((b[2][:, :, 1] > 0).sum()) - len(b[0]))
    top = np.argsort(-(pieces[:, :, 1] > 0).sum(axis=1), kind='stable')[:16]
    batch, pieces, nix = batch[top], pieces[top], nix[top]
    n_pieces = int((pieces[:, :, 1] > 0).sum())
    arena_c = [a.cpu() for a in arena_d]
    res = {}
    for name, d, ar in (('cuda', dev, arena_d), ('cpu', torch.device('cpu'),
                                                 arena_c)):
        prm = build_params(cfg_r, load_config(cfg_r), d)
        g = gather_digitize(prm, const_r, *ar, pieces,
                            torch.as_tensor(nix, device=d),
                            n_samples=T_cap, max_intervals=K)
        rec = pack_records(g['data'], g['left_all'], g['starts'], g['ends'],
                           g['counts'])
        res[name] = [x.cpu().numpy() for x in rec]
    same = all(a.shape == b.shape and np.array_equal(a, b)
               for a, b in zip(res['cuda'], res['cpu']))
    print(f'[cross-r] windows {len(batch)} pieces {n_pieces} T_cap {T_cap} '
          f'noise_ix {nix.tolist()[:4]}.. records {len(res["cuda"][0])} '
          f'cuda==cpu {same}')
    if not same or n_pieces <= len(batch):
        raise AssertionError('realistic digitize on the card differs from '
                             'the CPU twins (or the batch has no '
                             'afterpulse pieces)')

    # ---- 3j. the superposition entries on three window batches ------------
    stimes = superpose_measure(dev, smi)

    # ---- 3w. the arena gather and channel extents (K17) on three batches ---
    wtimes = window_rows_measure(dev, smi)

    # ---- 3k. the ZLE interval search and the record pack on four grids -----
    ztimes = zle_pack_measure(dev, smi)

    # ---- 3u. the record rows (K4r) and the round's copy to the arena ----------
    rtimes = record_rows_measure(dev, smi)

    # ---- 3l. the PMT-afterpulse generator and the diffused pattern ----------
    atimes = ap_diffuse_measure(dev, smi)

    # ---- 3m. the luminescence tables and the photon summaries ---------------
    ltimes = lumi_summaries_measure(dev, smi)

    # ---- 3n. the row truth and the per-PMT truth -------------------------------
    ntimes = pmt_truth_measure(dev, smi)

    # ---- 3o. the gas-gap luminescence times and the S2 photon times ---------
    otimes = photon_times_measure(dev, smi)

    # ---- 3p. the custom and the NEST S1 delays ------------------------------
    s1times = s1_delays_measure(dev, smi)

    # ---- 3c / 5c. the physics kernels and passes ---------------------------
    params_p, const_p, batches = physics_batches(cfg, inst, dev, 20261016)
    ptimes = phase_3c(params_p, const_p, batches, dev, smi)
    phase_5c(cfg, params_p, const_p, batches, smi)
    del params_p, batches

    # ---- 3d / 4d / 5d. the detector_physics configuration -----------------
    from wfsim_tpu_torch.config import detector_physics_overrides
    from wfsim_tpu_torch.interface import detector_physics_instructions
    from wfsim_tpu_torch.resources.nest_tables import build_nest_timing_tables
    from wfsim_tpu_torch.resources.synthetic import write_pattern_map
    tmp = tempfile.mkdtemp(prefix='wfsim_smoke_')
    try:
        t0 = time.perf_counter()
        map_path = write_pattern_map(Path(tmp) / 's2_pattern_map.json', 1234)
        t_write = time.perf_counter() - t0
        cfg_d = default_config(seed=1234, chunk_size=100,
                               **detector_physics_overrides(map_path))
        t0 = time.perf_counter()
        build_nest_timing_tables(cfg_d)
        t_nest = time.perf_counter() - t0
        t0 = time.perf_counter()
        load_config(cfg_d)
        t_map = time.perf_counter() - t0
        print(f'[detector] one-off host costs: NEST table build {t_nest:.3f} '
              f's, map read {t_map:.3f} s (map file written in '
              f'{t_write:.3f} s)')
        inst_d = detector_physics_instructions(512, 2000, 300)
        params_d, const_d, batches_d = physics_batches(cfg_d, inst_d, dev,
                                                       20261016)
        dtimes = phase_3d(params_d, const_d, batches_d, dev, smi)

        out, wall_d, launches_d, peak_d, sim = timed_run(cfg_d, inst_d, dev)
        rr, truth = out['raw_records'], out['truth']
        diag = sim.sim.rawdata.diag.summary()
        print(f'[detector] launches {launches_d}')
        for name in DETECTOR_PATH_KERNELS:
            if launches_d[name] <= 0:
                raise AssertionError(f'kernel {name} not launched on the '
                                     f'detector_physics path')
        s2_rows = truth[truth['type'] == 2]
        n_type = {t: int((truth['type'] == t).sum()) for t in (1, 2)}
        r_shift = (np.hypot(s2_rows['x'], s2_rows['y'])
                   - np.hypot(s2_rows['x_mean_electron'],
                              s2_rows['y_mean_electron']))
        if n_type != {1: 512, 2: 512} or len(truth) != len(inst_d):
            raise AssertionError(f'detector_physics truth rows {n_type}')
        if not (np.all(np.isfinite(r_shift))
                and np.all(np.abs(r_shift - 0.5) < 0.05)):
            raise AssertionError('mean electron positions off the 0.5 cm '
                                 'inverse FDC')
        if not strax_valid(rr, C):
            raise AssertionError('detector_physics raw_records violate the '
                                 'strax invariants')
        n_photons = int(truth['n_photon'].sum())
        print(f'[detector] truth rows by type {n_type}, S2 photons '
              f'{int(s2_rows["n_photon"].sum())}, S1 photons '
              f'{n_photons - int(s2_rows["n_photon"].sum())}, electrons '
              f'{int(s2_rows["n_electron"].sum())}, mean r shift '
              f'{r_shift.mean():.4f} cm')
        expect_records('detector_physics', len(rr), launches=launches_d)
        print(f'[detector] events/s {512 / wall_d:.2f} wall {wall_d:.3f} s '
              f'records {len(rr)} photons {n_photons} peak_mem '
              f'{peak_d / 2 ** 20:.1f} MiB ({smi})')
        print(f'[detector] phases {diag}')
        print(f'[detector] physics phases {physics_phases(sim)}')
        phase_5c(cfg_d, params_d, const_d, batches_d, smi, tag='cross-d')
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # ---- 3e / 4e / 5e. the he_full_grid configuration ----------------------
    launches_f = phase_full_grid(sargs, skw, ph, B, T, K, inst, dev, smi)

    # ---- 3f / 4f / 5f. the timing_models configuration ---------------------
    ttimes, launches_t = phase_timing_models(dev, smi)

    # ---- 3q / 4q / 5q. the field_maps configuration -----------------------
    qtimes, launches_q = phase_field_maps(dev, smi)

    # ---- 4r / 5r. the optical configurations; 4t. the legacy pulses ---------
    launches_o = phase_optical(dev, smi)
    phase_legacy_pulses(dev, smi)

    # ---- 4v. unknown instruction types; resource names found nowhere -------
    phase_gaps(realistic_digest, dev, smi)

    # ---- 3g / 4g / 3h / 4h / 5h. per_pmt_truth and xenon1t_full_grid -------
    xtimes, launches_p, launches_x = phase_per_pmt_x1t(B, T, K, inst, dev,
                                                       smi)

    # ---- 3i / 4i. the multi-device path -------------------------------------
    mtimes = phase_3i(cfg, params, const, dev, smi)
    launches_m = phase_4i(cfg, inst, main_digest, dev, smi)

    # ---- 4s. the stream ----------------------------------------------------
    phase_4s(dev, smi)

    src = 'wfsim_tpu_torch/csrc/'
    rows = []

    def measured(name, cu, replaces, entries, launch_counts, m):
        b_ms, b_by = bound(m['bytes'], m['ops32'], m['ops64'])
        rows.append(dict(name=name, route='cuda', source=src + cu,
                         replaces=replaces, entry_points=list(entries),
                         launches=min(launch_counts[e] for e in entries),
                         max_abs_err=m['err'], ms=m['ms'],
                         device_ms=m['device_ms'], host_us=m['host_us'],
                         plain_ms=m['plain_ms'], bound_ms=b_ms, bound_by=b_by,
                         library_ms=m['library_ms'],
                         optical_launches={
                             cfg_name: min(lc[e] for e in entries)
                             for cfg_name, lc in launches_o.items()}))

    for row, m in stimes.items():
        name = row.removesuffix('_' + m['shape'])
        rep, entry, counts = {
            'superpose_adc': ('wfsim_tpu/ops/waveform.py:68; '
                              'wfsim_tpu/ops/waveform.py:146',
                              'wfsim_superpose_adc', launches),
            'superpose_adc_noise': ('wfsim_tpu/pipeline/digitize.py:67',
                                    'wfsim_superpose_adc', launches_r),
            'superpose_adc_full': ('wfsim_tpu/pipeline/digitize.py:341; '
                                   'wfsim_tpu/pipeline/digitize.py:96',
                                   'wfsim_superpose_adc_full', launches_f),
            'superpose_adc_full_no_he': (
                'wfsim_tpu/pipeline/digitize.py:341; '
                'wfsim_tpu/pipeline/digitize.py:96',
                'wfsim_superpose_adc_full', launches_x)}[name]
        measured(row, 'superpose_adc.cu', rep, [entry], counts, m)
        rows[-1].update(library_call=m['library_call'],
                        library_calls=m['library_calls'],
                        library_diff=m['library_diff'],
                        library_peak_mib=m['library_peak_mib'],
                        syncs=m['syncs'], photons=m['photons'])
    for row, m in wtimes.items():
        measured(row, 'window_rows.cu',
                 'wfsim_tpu/pipeline/digitize.py:224-260; '
                 'wfsim_tpu/pipeline/digitize.py:270-284',
                 list(WINDOW_KERNELS), launches, m)
        rows[-1].update({k: m[k] for k in (
            'syncs', 'photons', 'kept', 'windows', 'device_call_ms',
            'library_call')})
    for row, m in ztimes.items():
        name = row.removesuffix('_' + m['shape'])
        cu, rep, entries = {
            'zle_intervals': ('zle_intervals.cu',
                              'wfsim_tpu/ops/zle.py:30; '
                              'wfsim_tpu/ops/zle.py:119',
                              ['wfsim_zle_intervals']),
            'pack_records': ('pack_records.cu',
                             'wfsim_tpu/pipeline/digitize.py:471',
                             list(ZLE_PACK_KERNELS[1:]))}[name]
        measured(row, cu, rep, entries,
                 launches_f if m['shape'] == 'full' else launches, m)
        rows[-1].update(syncs=m['syncs'], records=m['records'],
                        in_window=m['in_window'])
    m = rtimes['round_order']
    measured('round_order', 'round_order.cu',
             'wfsim_tpu/pipeline/rawdata.py:1780', ['wfsim_round_order'],
             launches, m)
    rows[-1].update({k: m[k] for k in (
        'syncs', 'records', 'windows', 'library_call', 'split',
        'max_window', 'rounds')})
    m = rtimes['record_rows']
    measured('record_rows', 'pack_records.cu',
             'wfsim_tpu/pipeline/rawdata.py:1785', ['wfsim_record_rows'],
             launches, m)
    rows[-1].update({k: m[k] for k in (
        'syncs', 'records', 'windows', 'library_call', 'library_calls',
        'library_diff', 'sort_ms', 'round_records_ms', 'bound_rows_ms',
        'copy', 'arena_base_rows')})
    for row, m in atimes.items():
        if row.startswith('pmt_afterpulse'):
            measured(row, 'pmt_afterpulse.cu',
                     'wfsim_tpu/models/afterpulse.py:56', AP_KERNELS,
                     launches_r, m)
        else:
            measured(row, 'grid_lookup.cu', 'wfsim_tpu/models/s2.py:300',
                     ['wfsim_pattern_diffuse'], launches_d, m)
        rows[-1].update(syncs=m['syncs'], split=m['split'])
    for row, m in ltimes.items():
        if row.startswith('lumi_tables'):
            measured(row, 'luminescence.cu',
                     'wfsim_tpu/models/s2.py:167; wfsim_tpu/models/s2.py:141',
                     ['wfsim_lumi_tables'], launches, m)
            rows[-1].update(seq_rows=m['seq_rows'])
        else:
            measured(row, 'pmt_afterpulse.cu',
                     'wfsim_tpu/models/afterpulse.py:184', SUMMARY_KERNELS,
                     launches_r, m)
        rows[-1].update(syncs=m['syncs'], split=m['split'])
    for row, m in ntimes.items():
        if row.startswith('row_truth'):
            measured(row, 'pmt_response.cu', 'wfsim_tpu/models/pmt.py:89; '
                     'wfsim_tpu/models/pmt.py:171', ['wfsim_pmt_row_truth'],
                     launches, m)
        else:
            # the XENON1T row counts the launches of that configuration's run
            measured(row, 'pmt_response.cu', 'wfsim_tpu/models/pmt.py:146',
                     ['wfsim_pmt_row_truth_per_pmt'],
                     launches_x if row == 'per_pmt_248' else launches_p, m)
        rows[-1].update(syncs=m['syncs'], split=m['split'],
                        second_pass=m['second_pass'],
                        library_diff=m['library_diff'])
    for row, m in otimes.items():
        cu, rep, entry = (
            ('table_samplers.cu', 'wfsim_tpu/models/s2.py:255',
             'wfsim_lumi_gasgap_times') if row.startswith('lumi_gasgap') else
            ('photon_times.cu', 'wfsim_tpu/models/s1.py:143',
             'wfsim_s1_photon_times') if row.startswith('s1_') else
            ('photon_times.cu', 'wfsim_tpu/models/s2.py:381',
             'wfsim_s2_electron_times') if row.startswith('s2_electron') else
            ('photon_times.cu', 'wfsim_tpu/models/s2.py:441',
             'wfsim_s2_photon_times'))
        # the gas-gap and NEST rows count the detector_physics run's
        # launches, the custom row the timing_models run's
        measured(row, cu, rep, [entry],
                 launches_d if 'gasgap' in row or row.endswith('_nest') else
                 launches_t if row.endswith('_custom') else launches, m)
        rows[-1].update(syncs=m['syncs'], split=m['split'],
                        bound_old_ms=bound(m['bytes_old'], m['ops32'],
                                           m['ops64'])[0])
    for name, cu, rep in (
            ('channel_draw', 'channel_draw.cu', K5_REPLACES),
            ('channel_draw_skewed', 'channel_draw.cu', K5_REPLACES),
            ('pmt_photon_pass', 'pmt_response.cu',
             'wfsim_tpu/models/pmt.py:19'),
            ('pmt_row_truth', 'pmt_response.cu',
             'wfsim_tpu/models/pmt.py:89; wfsim_tpu/models/pmt.py:171')):
        measured(name, cu, rep, ['wfsim_' + name.replace('_skewed', '')],
                 launches, ptimes[name])
    for name, entry, cu, rep in (
            ('grid_lookup', 'wfsim_grid_lookup', 'grid_lookup.cu',
             'wfsim_tpu/ops/interp.py:85'),
            ('grid_lookup_3d', 'wfsim_grid_lookup', 'grid_lookup.cu',
             'wfsim_tpu/ops/interp.py:85'),
            ('grid_lookup_512', 'wfsim_grid_lookup', 'grid_lookup.cu',
             'wfsim_tpu/ops/interp.py:85'),
            ('grid_lookup_photons', 'wfsim_grid_lookup', 'grid_lookup.cu',
             'wfsim_tpu/ops/interp.py:85')):
        measured(name, cu, rep, [entry], launches_d, dtimes[name])
    for name, m in ttimes.items():
        measured(name, 'table_samplers.cu', 'wfsim_tpu/models/s2.py:234',
                 ['wfsim_lumi_garfield_times'], launches_t, m)
        rows[-1].update(syncs=m['syncs'], split=m['split'],
                        photons=m['photons'])
    for name, m in s1times.items():
        # the NEST rows count the detector_physics run's launches
        entry, rep, counts = (
            ('wfsim_nest_delays', 'wfsim_tpu/models/s1.py:108', launches_d)
            if name.startswith('nest') else
            ('wfsim_s1_custom_delays', 'wfsim_tpu/models/s1.py:56',
             launches_t))
        measured(name, 'table_samplers.cu', rep, [entry], counts, m)
        rows[-1].update(syncs=m['syncs'], split=m['split'],
                        photons=m['photons'])
    for name, m in qtimes.items():
        if name.startswith('grid_lookup'):
            measured(name, 'grid_lookup.cu', 'wfsim_tpu/ops/interp.py:85',
                     ['wfsim_grid_lookup'], launches_q, m)
        else:
            measured(name, 'luminescence.cu',
                     'wfsim_tpu/models/s2.py:167; wfsim_tpu/models/s2.py:141',
                     ['wfsim_lumi_tables'], launches_q, m)
    measured('pulse_truth_per_pmt', 'pmt_response.cu',
             'wfsim_tpu/models/pmt.py:146', ['wfsim_pmt_row_truth_per_pmt'],
             launches_p, xtimes['pulse_truth_per_pmt'])
    for row, m in mtimes.items():
        measured(row, 'superpose_adc.cu', 'wfsim_tpu/parallel/sharding.py:54',
                 ['wfsim_superpose_block'], launches_m, m)
        rows[-1].update(syncs=m['syncs'], split=m['split'],
                        library_call=m['library_call'],
                        library_calls=m['library_calls'],
                        library_diff=m['library_diff'], photons=m['photons'])
    expect_no_sequential_rows('every phase after 3m')
    print(f'[done] chip_smoke.py took {time.perf_counter() - t_start:.1f} s '
          f'after its start ({smi})')
    print(smi)
    print(json.dumps({'kernels': rows}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': kind,
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()
