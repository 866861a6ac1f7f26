"""Chip smoke test of tpuparquet_torch on one NVIDIA GPU.

    python3 chip_smoke.py [--values N] [--groups G]

1. Builds the port's twenty-two CUDA kernels (K1-K13 on the read path,
   KE1-KE5 on the write path, KS1-KS4 in the sharded scan) and its C
   host helpers (snappy, hybrid run
   scans, bit packing, the DELTA_BINARY_PACKED block walk and the
   DELTA_BYTE_ARRAY passes, lane planes, BYTE_ARRAY passes) from the
   sources in this checkout, one compiler process per source, in
   parallel.
2. Holds every kernel against its plain PyTorch version on the card, bit
   for bit over the whole (padded) output: K1 at the edges of its
   2,048-lane tiles and 4-lane groups (UNPACK_EDGE_CASES: widths 0, 1,
   2, 3, 7, 8, 13, 16, 17, 31 and 32 at counts 1, 3, 4, 5, 31, 32, 33,
   around a tile, 3 tiles + 5 and 2^21 + 3, words from views 1-3 words
   in, every stream ending exactly at ceil(count / 32) * width words),
   K2 at the edges of its 2,048-slot tiles (HYBRID_EDGE_CASES:
   rate_code's shape, one RLE run, one bit-packed run kept as a table, a
   run-dense width-1 stream whose tiles meet more runs than a block
   stages, run ends on tile edges, runs of length 0, a table without
   padding runs, bit-packed lanes clamped past nbp and below 0, widths 0,
   1, 3, 8, 17 and 32, counts 1, 5, around a tile and 2^21 + 3, words
   and table from views off 16-byte boundaries), K4 at the edges of its
   8,192-slot tiles and 4-slot lanes (LEVELS_EDGE_CASES: sizes 1, 3, 4,
   5, around a tile, 9 tiles + 3 and 2^21 + 3, all null, no nulls,
   max_def 1 and 3, def levels from views 1-3 words in), K5 at the edges
   of its 2,048-value tiles (PLANES_EDGE_CASES: counts 1024, 1025, 1027,
   around a tile and 2^20 + 3, raw slabs 1-3, runs of length 1 (more than
   a block stages), one run over the page, run ends on tile edges, table
   slices past 0, lanes 1-4, buffers from views off 16-byte boundaries),
   each output allocated over garbage; K13 at row lengths 1, 3, 4,
   5, 7, 8, 9, 12, 13, 16, 17, 20, 22, 24 and 1,031, at counts around
   its tiles and from views 1, 3, 5, 8 and 13 bytes into their buffer,
   K3 at 3 and 4 lanes, K12 with k != 4 * lanes and at the edges of its
   tiles (BSS_EDGE_CASES: every k from 1 to 16, counts 1, 15, 16, 17,
   around a tile, 5 tiles + 7 and 3 tiles + every residue 1-15 mod 16,
   streams from views 1, 3, 5, 8 and 13 bytes into their buffer and of
   exactly k * count bytes, rows of 1,024 bytes that fill a block's
   shared memory and of 1,025, 1,031 and 2,053 whose lanes split over
   gridDim.y), K8 on the copy graph
   of front-coded strings and rows and at the edges of its tiles (a
   chain through 19 tiles, copies across tile edges, 4-byte
   offsets from more than 64 KiB back, literals longer than a tile,
   words at offsets 0, 1 and 3 of a block of 3 mod 4 bytes), K9 on a
   value longer than its block's share, 5,000 empty values across block
   edges, a tail read from the last slot's entry and indices past the
   dictionary; K10 at pos 0-3 and 7, on a value over two tiles, on
   runs of empty values inside a tile and on its edge, on values' bytes
   one short of and one past a tile, on unpadded offsets and on short
   blobs; K7 at the edges of its 4,096-value tiles (totals 4095 to
   8193 and 38 tiles), block sizes 1, 3, 127, 128, 256, the stream's
   own and 2^21 + 2, and deltas read from views that are not 8-byte
   aligned; KE1 at widths 1, 7, 31, 32, 33, 63 and 64 (counts 1, 33 and
   2^20 + 5, over a miniblock list) and where its warps have edges
   (PACK_EDGE_CASES: widths 1, 31, 32, 33 and 64 at counts 1, 31, 33 and
   one value past a warp's and a block's share of miniblocks, miniblock
   lists reversed, with repeats and over a source whose last lanes are
   missing, inputs shorter than the count), KE2 at (k, lanes) (4, 1), (4, 2),
   (8, 2), (3, 1), (9, 3), (16, 4) and (1601, 401), at counts around
   its tiles and past 2^20 (stream starts off 16-byte boundaries) and
   from a view one word into its buffer, KE3 on wrapping int32 and extreme int64 deltas
   at the edges of a warp's 4 blocks and a CTA's 32 and on values one
   word into their buffer, KE4 on uniform values at ranges 1, 7, 2^16
   and 2^22 and on either side of its shared-memory threshold, on a hot
   value and on first occurrences at a warp's and a block's last index,
   KE5 on NaN, infinities, signed zeros and unsigned order and where its
   design has edges (MINMAX_EDGE_CASES: one value, a vector's values and
   one past, a block's round and one past, views 1 and 2 words in and a
   2-lane view 1 word in, the extremes in the last block's last vector,
   NaN in the tail only, all NaN, calls back to back whose grids differ,
   the keys' host buffer over garbage);
   KS1 at 1-4 lanes, all-null and without nulls, into a longer row; KS2
   at widths 0, 1, 7 and 32 on every slot of sp 1, 2 and 4 with indices
   past the dictionary, and at the edges of its tiles (STEP_EDGE_CASES:
   counts around a tile, padded positions clamped into a bit-packed last
   run, an RLE run over a tile edge, shares on sp 3 that start off
   16-byte boundaries, a tile that meets more runs than a block
   stages); KS3 with leading nulls and empty strings, and at the edges
   of its tiles (DENSIFY_CASES: slots around a tile and 9 tiles of
   look-back, all nulls, no values, no slots, no mask, 15-17 data bytes,
   a data view 3 bytes in, padded rows, rows of a block that start off
   16-byte boundaries); KS4 with padding rows, on word and byte rows.
3. Writes the NYC-Taxi-shaped config-2 file of ``bench.py`` (seed 42, 8
   row groups, 50,000,000 values by default) with the port's writer and
   reads it through ``read_row_groups_device`` on the card with the
   default PLAIN wire transports (byte planes, delta lanes, snappy
   tokens), then again with ``TPQ_DEVICE_SNAPPY/PLANES/DELTA=0`` (no
   transport).  Each read checks every value, rep and def level and mask
   against the generator, row group 0 against the CPU run buffer for
   buffer, and the routing counters; each is timed best of 3.
   Every read of phases 3-3h runs through the pipeline of
   ``pipelined_reads`` (the columns planned on a pool of
   ``TPQ_PLAN_THREADS`` workers, by default one a usable CPU): each is
   read again at ``TPQ_PLAN_THREADS=1``, and its buffers, routing
   counters, ``bytes_staged``, ``pages_crc_verified`` and per-kernel
   launch counts must equal the default's; each is timed best of 3 at
   both worker counts, printing both walls and ``plan_s`` (the workers'
   seconds summed), ``transfer_s``, ``dispatch_s`` and values/s.
   Config 2 is also timed at 1, 2, 4 and the usable CPU count of
   workers, read from a file path (range reads: ``bytes_read`` must
   equal the chunks' compressed bytes, the buffers the in-memory read's)
   and twice under ``TPQ_PLAN_CACHE_MB=64`` (as is the sensor table of
   3f): the warm pass must hit the plan cache once a chunk and miss
   none, with the cold pass's routing and buffers.
   3b. Does the same for the transport mix, a file on which every route
   engages (snappy tokens with and without levels, delta lanes at widths
   7 and 39, byte planes), with the default transports.
   3c. Config 4 of ``bench.py`` (dictionary strings beside PLAIN
   doubles, data page v2, 8 row groups of 1,562,500 rows), default
   transports: K9 decodes the strings, and no page takes a transport.
   3d. The string mix (long distinct URLs, with and without nulls, and
   random hex tokens; V1, 8 row groups of 250,000 rows): the URL pages
   ship snappy tokens, K8 expands them and K10 gathers the values; the
   tokens ship raw.
   3e. Config 3 of ``bench.py`` (DELTA_BINARY_PACKED int64 timestamps in
   a nullable LIST, seed 3, 8 row groups of 2,083,333 rows, 59,096,968
   level slots): rep and def levels through K1, the deltas through K1
   and K7, validity through K4.
   3f. The sensor table (bursty DELTA_BINARY_PACKED timestamps and an
   optional int32 sequence beside BYTE_STREAM_SPLIT float and double
   readings; 8 row groups of 1,562,500 rows): K11 places the scattered
   miniblock width classes, K12 turns the byte streams into lanes.
   3g. A Spark-style table (seed 19; V1, 8 row groups of 1,250,000 rows):
   INT96 event times (byte planes at 3 lanes, K5) and dictionary
   midnights (K3 at 3 lanes), an optional BOOLEAN (K1 at width 1, K4),
   optional DECIMAL(38, 18) and UUID fixed_len_byte_array(16) columns
   (PLAIN rows shipped as lane words).
   3h. A parquet-mr v2 table (seed 23; data page V2, 8 row groups of
   1,000,000 rows): RLE booleans (K1/K2), DELTA_BYTE_ARRAY sorted URLs
   (K8), random session ids (assembled on the host) and DECIMAL(38, 9)
   rows (K8 then K13), DELTA_LENGTH_BYTE_ARRAY notes.  K8 must launch
   once per URL and amount page, K13 once per amount page, and no
   session page may take K8.
   3i. Config 2 written by the port's writer in ZSTD (the phase-3 values,
   8 row groups), and in GZIP and LZ4_RAW at a fifth of the values in 2
   row groups, each read on the card as in phase 3 (the generator, the
   CPU run, one plan worker; best of 3 at both worker counts, beside the
   SNAPPY file's size): the routing and every kernel's launches must be
   the SNAPPY file's of the same values (delta lanes and byte planes on
   the decompressed values; no page takes the snappy tokens).
4. Times each kernel at the main paths' page shapes with CUDA events,
   beside its memory/operation bound, its plain version and, where one
   PyTorch call computes the function or its core, that call; the
   device time of one call of the kernel and of the library call from a
   torch.profiler trace; K1, K2, K4, K5 and K12 also their CUDA launches
   a call and the bytes their designs move per output byte (arithmetic),
   K2 its table's run count and the most runs one tile meets, K5 its
   page's spec and the most runs one table meets in a tile; K7 and KE3
   also their CUDA launches a call and the bytes they move a value, K13
   and KE2 their launches a call, the bytes their designs move per input
   byte (arithmetic, not a counter)
   and the page's count % 16, K13's row tiles timed against one thread
   a word at 5-, 6- and 7-byte decimal rows; K8 also
   on a URL page of 3h, and for both K8 pages the doubling rounds their
   chains need beside the reference's ``steps``, the share of positions
   that leave their tile, CUDA launches a call and bytes moved per
   output byte (K9: launches and bytes too); KE1-KE5 at phase 5's pages,
   KE1 and KE5 with their CUDA operations a call and the bytes moved per
   input byte by this design's arithmetic and the parent's, KE5 also
   with its keys copied by cudaMemcpyAsync instead of written to the
   mapped buffer
   (``ke5_copied``); KS1-KS4 at phase 6's shapes (phases 5 and 6
   run first: their launches fill the KE and KS rows), KS2 and KS3 with
   their launches a call and bytes moved by their designs' arithmetic,
   KS2 also at tiles of 128, 256 and 512 positions.
5. The write path: the sensor table of 3f and config 2 of 3 are read
   on the card, every column goes through ``DeviceColumn.as_values()``
   (optional columns with the mask of their read), and the writer that
   made each file writes them back from the card (SNAPPY, the file's
   encodings).  Each new file must equal the original byte for byte,
   with 4 (sensor table: DELTA_BINARY_PACKED by KE3 and KE1,
   BYTE_STREAM_SPLIT by KE2, statistics by KE5) and 2 (config 2: the two
   PLAIN columns; the other three intern on the card, KE5 then KE4)
   pages a row group encoded on the card.  The writes run on the
   writer's pool of encode workers (one a usable CPU); the sensor
   table's writes from DeviceValues and from numpy are timed, best of 3,
   at the default workers and at one.  Config 2's writes
   (``check_native_writes``) go from numpy and from DeviceValues at one
   and the default encode workers, on the native page path and on the
   pure one (forced), best of 3 in turns: the eight files are byte-equal; on the native leg every data
   page is assembled by ``csrc/page.c`` (``pages_assembled_native`` =
   ``pages_written`` less the dictionary pages), on the pure leg none;
   the walls and the native leg's ``write_encode_s``,
   ``write_compress_s`` and ``write_assemble_s`` are printed.
   5b. Config 2 written in ZSTD from numpy at one encode worker must
   equal phase 3i's file of the default workers; both are timed, best of
   3.  A one-column PLAIN int64 file of one 64 MiB page, in ZSTD and in
   GZIP at the default workers: the page body splits into 64 blocks of 1
   MiB (``codec_split_blocks``), and read back on the card the values
   equal the generator and the ZSTD body decodes its 64 frames one a
   worker (``codec_split_frames``; gzip members inflate in one loop).
6. The sharded scan: ``ShardedScan`` over config 2's file (6a) and
   config 4's (6b) on the default mesh (1x1, the card), ``run()``, then
   ``gather_column`` of every fixed-width column (KS1) and
   ``gather_byte_column`` of both string columns (KS3), replicated and
   with ``gather_to=0`` (KS4); every gathered unit equals the generator
   (null slots 0 or empty) and the unit's own read.  6c does both again
   on a 2x2 mesh of four slots on the card: every array equals 6a's and
   6b's bit for bit, and the replicated gathers move 4x the bytes.  6d
   runs ``sharded_dict_decode`` on both meshes (KS2, one launch a slot;
   sp 1 and 2) over the index streams of config 2's dictionary columns
   as the file holds them, each chunk's dictionary a lane group of one
   dictionary; each unit equals its row group's read.  ``run()`` (through
   ``pipelined_unit_scan``) and each gather are timed best of 3, with
   ``gather_reshard_s``.  Each gather also runs with ``gather_to="cpu"``,
   a sink outside the mesh of the card's slots (the direct assembly:
   each unit's row copied once to the host, no KS4), which must equal
   the replicated and the in-mesh placed gather.
7. The multi-process scan: the script runs itself as two processes
   (``--multihost-child``), which join a gloo group over localhost and
   scan config 2's file with ``MultiHostScan``, each on the default mesh
   of its process (the one card, shared), each decoding its stride of
   the row groups.  7a: ``run_with_stats()``, ``counts_allgather()`` and
   an ``allgather_host`` of every unit's checksum (``unit_checksum``, on
   the card): the checksums equal this process's own reads of phase 6a,
   the fleet's ``row_groups``, ``chunks`` and ``values`` equal the
   footers' and every fleet counter is the processes' sum (``wall_s``
   their maximum), and each process launched config 2's kernels
   (``MULTIHOST_KERNELS``: K1-K5 and K7).  7b: both stop after their
   first unit with ``resume_from=`` and ``checkpoint_every=1``, their
   files ``ckpt.p0`` and ``ckpt.p1`` must exist, two fresh processes
   resume, and the four runs yield every unit once.  7c: ``run()`` timed
   as the slower process's wall, best of 3, at the default plan workers
   and at half the usable CPUs a process, beside 6a's one-process
   ``run()``.  A process that fails fails the run (its peer is killed).
   Each process of 7a runs with the latency digests and the profiler
   (200 Hz) armed and folds its digests, profile and ledgers with
   ``allgather_digests``, ``allgather_profiles`` and
   ``allgather_ledgers``: each fold equals the merge of the two
   processes' own states, exactly (``check_fleet_folds``).
8. Consumer meshes and the resilient read ladder.  8a: phase 6a's and
   6b's columns gathered under a ``NamedSharding`` over a consumer mesh
   of two ``cuda:0`` slots with ``P("data")``, and the fixed-width
   columns of two lanes over a 2x2 consumer mesh with ``P("data", None,
   "model")`` (KS1, KS3 and KS4, the counts set to 0 just before): every
   shard lies on its slot, the padding rows are zero, and ``to_numpy()``
   equals the replicated gather bit for bit; then
   ``read_row_groups_device(out_sharding=...)`` round-robins config 2's
   row groups over the slots, equal to 6a's units.  8b: config 2 under
   ``ShardedScan(on_error="quarantine", retries=2)`` and
   ``inject_faults()``, injected faults only: ``kernels.device.
   unit_dispatch`` failing once on one unit (one retry, no degradation,
   every unit as 6a's), then three times (the unit degraded: its data
   pages all ``pages_degraded``, its values as 6a's bit for bit, no K3
   launch over it); ``kernels.device.page_payload`` corrupted on one
   column's page (that unit quarantined with its file, row group and
   column, the others as 6a's); ``kernels.device.hang`` under
   ``unit_deadline=2`` (that unit quarantined as
   ``DeadlineExceededError`` within its budget and 1 s).  8c: ``run()``
   in quarantine mode with no fault, best of 3, beside 6a's pipelined
   ``run()``; and no path of phases 3-7 retried a dispatch or degraded
   a page or a unit.
9. Filtered reads (``check_filtered``).  9a: config 2's values written
   with 65,536-slot data pages, the page index and bloom filters on
   ``rate_code`` and ``passenger_count``, read unfiltered on the card
   (every value against the generator, row group 0 against the CPU run),
   best of 3 at the default plan workers and at one.  9b:
   ``read_row_groups_device(filter=)`` of ``pickup_ts`` under about a
   tenth of each row group's span (the page index prunes most pages),
   ``trip_distance_mm > 50000`` (the statistics prune every row group),
   ``(rate_code == 3) & payment_type.not_null()`` (nothing pruned, about
   19% survive) and ``trip_distance_mm >= 0`` (every row): each equals
   the generator's post-filter value for value, level for level and
   mask for mask, the first kept row group's buffers the CPU run's, its
   ``row_groups_pruned``, ``pages_pruned``, ``rows_pruned``,
   ``filter_rows_in`` and ``filter_rows_out`` the counts worked out from
   the generator and the page bounds, and it launches no read kernel
   (the host decodes the surviving rows and the card receives them);
   each is timed best of 3 at both worker counts beside 9a's pass.  9c:
   10,000,000 rows in 8 row groups whose int32 column holds even values,
   filtered on an odd value inside its bounds: every row group pruned by
   its bloom filter (``bloom_hits`` 8), no page read.  9d:
   ``ShardedScan(filter=)`` on the 1x1 mesh over 9a's file (the
   ``pickup_ts`` filter) and the string mix (``token < "2"``), every
   gathered unit (replicated and on device 0) against the post-filter,
   KS1 and KS3 launching on the uneven units.
10. Salvage, strict metadata, hedged replica reads and
   ``decode_chunk_device`` (``check_robustness``).  10a: config 2 as
   phase 3 wrote it (the writer's defaults, so with its salvage hint)
   damaged five ways (``damaged_copies``: a cut at row group 4's end, a
   cut mid-page in row group 5, a cut inside a page header of row group
   6, the footer length flipped, a footer that lies about one chunk's
   offset over intact pages), each row-group count worked out from the
   intact footer; each opened with ``salvage=True`` (``files_salvaged``
   1, ``row_groups_recovered`` exact) and read on the card with K1-K5
   and K7 launching, every buffer equal to the intact read's, which
   equals the generator; the lying footer under ``strict_metadata=True``
   raises ``CorruptFooterError`` (``metadata_rejects`` 1); the salvage
   open (the forward scan) timed beside a plain open.  10b:
   ``ShardedScan([intact, torn], on_error="quarantine", salvage=True)``
   on the 1x1 mesh: the torn file's entry ``"salvaged"``, its prefix
   units equal to 6a's and the generator.  10c: config 2 on disk beside
   a byte-equal mirror, every primary chunk read hung for 3 s
   (``io.chunk.hang``) under ``hedge_delay=0.05``: the hedged read equals
   the plain read from the path buffer for buffer with ``hedges_won`` at
   least the chunk reads (timed beside the plain pass and phase 3's),
   ``ShardedScan([[p, m]], on_error="quarantine")`` equals 6a's units
   with nothing quarantined, and with no mirror and ``read_deadline=1``
   a read raises ``DeadlineExceededError`` within its budget and 1 s.
   10d: ``decode_chunk_device`` of each chunk of row group 0 equals
   ``read_row_group_device``'s buffers, config 2's kernels launching.
11. The writer's nested surface and the telemetry (``check_telemetry``).
   11a: the nested table (``build_nested``: an optional struct ``pickup
   { required int64 ts; optional int32 zone; }`` with null groups and
   null fields, a MAP<int32, int64> with null rows, empty maps and null
   values, a LIST of an optional struct<int64, double> with null rows,
   empty lists, null elements and null fields; 8 row groups, about 50M
   level slots) written from ``DeviceValues`` on the card at 1 and the
   default encode workers and from numpy: the four files are byte-equal,
   KE4 and KE5 launch on the card write; read back with
   ``read_row_groups_device`` (K1-K4 launching), every value, rep and
   def level and mask equals the generator's (``_want_nested``); written
   and read values/s, best of 3.  11b: config 2 best of 3 at the default
   plan workers with tracing off, then with ``TPQ_TRACE`` on and
   ``collect_stats(events=True)``: one connected span tree, ``plan`` and
   ``read`` spans = columns x row groups, ``unit``, ``transfer`` and
   ``dispatch`` spans = row groups, event-log pages = the ``pages``
   counter = the page histograms' counts, the live registry's counters
   and histograms = the collector's, and the traced pass's launches =
   the untraced pass's; both walls and their ratio; then one traced pass
   under torch.profiler and the device busy share (the union of the
   card's kernel, copy and memset intervals over the pass's own
   interval).  11c: a quarantine-mode ``ShardedScan`` of config 2 with
   one corrupt page injected, ``postmortem=`` a path and
   ``TPQ_TRACE_EXPORT`` set: one incident a quarantined unit with a
   non-empty flight-recorder tail, and the exported trace loads
   (``load_trace_file``) as one tree.
12. The telemetry's second part (``check_armed_scan``): config 2 from its
   path through ``ShardedScan`` on the 1x1 mesh at the default plan
   workers, with a progress file, the latency digests, the time-series
   ring, the sampling profiler at 500 Hz, tracing, an SLO file
   (``PHASE12_OBJECTIVES``) and an alert engine of ``default_rules``
   with its record file.  12a: the last progress frame is ``done`` with
   every unit and row, its attribution's bytes equal the collector's
   (``bytes_read`` the footers' chunk bytes, ``bytes_staged`` phase 3's).
   12b: the ledgers summed equal the live registry's totals, exactly.
   12c: the ``unit`` digest counts every unit (p50, p95, p99 printed),
   the ``scan`` digest the run.  12d: the ring's ``scan_end`` frame
   meets every objective; a second run whose first chunk read hangs 2 s
   under ``read_deadline=1`` yields the same units with one
   ``deadline_exceeded``, samples the hung read as ``[io-wait
   io.reader.chunk_read]``, and the default rules' burn-rate alert lands
   in the record file.  12e: the profile's samples by (label, stage), on
   and off CPU, ``profile_consistency`` against the trace's stage seconds
   (no finding), the top 10 frames of ``plan``, ``transfer`` and
   ``dispatch``; a hand-driven sample inside each transfer and dispatch
   window of the calling thread carries that stage; the armed/off
   ``run()`` wall ratio at 50 and 500 Hz, best of 3 in turns.  12f: the
   armed run launches config 2's kernels (K1-K5, K7).
13. The serve arbiter (``check_arbiter``): a ``ResourceArbiter`` over the
   usable CPUs with two tenants of weights 1 and 3 (``PHASE13_TENANTS``)
   is activated, and two ``ShardedScan`` runs of config 2 on the 1x1 mesh
   go at once, each on a thread of its own under its
   ``tenant_scope``: inside it ``_plan_threads()`` and
   ``_write_threads()`` equal the tenant's share, the pair launches
   config 2's kernels (K1-K5, K7), and each scan's units equal 6a's.  A
   full queue is refused with ``AdmissionRejected`` (``queue_full``,
   the tenant's last job wall as its retry-after); after
   ``note_job_done`` and ``rebalance`` the shares and tenant states are
   printed.  The pair's wall beside one unbound scan alone, best of 3 in
   turns.  Deactivated, ``_plan_threads()`` and ``_write_threads()`` are
   what they were before the arbiter.
14. Remote sources, the range caches and ``DatasetScan``
   (``check_remote``), config 2 from a file in a temporary directory,
   one ``read_row_group_device`` call a row group (each row group's
   chunk ranges prefetched as coalesced spans into the disk tier),
   beside the same loop in memory and from the path.  14a: through
   ``EmulatedStoreSource`` (``PHASE14_EMU``: 2 ms a request, a throttle,
   a reset and a short response every 7th, 11th and 13th request), cold
   (empty tiers) then warm, at the default and 1 plan worker: buffers
   equal to the in-memory read's; cold, ``remote_ranges_fetched`` the
   spans, ``ranges_coalesced`` the chunks less the spans,
   ``remote_bytes`` the spans' bytes, ``remote_retry`` the faults the
   emulator fired in the pass, a disk hit a chunk; warm, no fetch and a
   disk hit a chunk.  14b: the same through ``HttpByteRangeSource`` from
   ``ThrottlingOrigin`` on 127.0.0.1, every 5th request
   answered 429 with ``Retry-After`` (``remote_retry`` the 429s).  14c:
   two processes (``--remote-child``) over one ``TPQ_CACHE_DISK_SHARED``
   directory at once: each one's row-group checksums equal the local
   read's; fleet disk hits twice the chunks, no miss, no eviction, the
   chunks asked of the store between one and two times the chunks,
   ``remote_retry`` the fired faults, an entry a chunk, no lock left.
   14d: config 2's row groups written into four hive partitions
   (``region=<v>/part-0.parquet``) read by ``DatasetScan`` from an
   ``emu://`` root with a filter on ``region`` that prunes two:
   ``dataset_files_pruned`` 2, units equal a ``ShardedScan`` of the
   survivors' buffer for buffer, gathers (replicated and to device 0)
   the generator's, K1-K5, K7, KS1 and KS4 launching.
15. The scan server and the command-line tool over config 2's file
   (``check_server``), every job a quarantine-mode ``ShardedScan`` on
   the 1x1 mesh.  15a: a ``ScanServer`` with phase 13's tenants and
   weights runs two jobs a tenant; each ends ``done`` with 6a's units,
   the jobs launch K1-K5 and K7, each tenant's ledger is under its label
   and the ledgers summed equal the live registry's totals; the status
   document is printed, and one job a tenant at once is timed best of 3
   beside phase 13's pair.  15b: a drain asked for when the first unit
   lands: the running job ends ``drained`` with its cursor flushed, the
   queued one comes back ``drained``, and a successor on the same state
   directory resumes both; the union of the keyed outputs is 6a's units,
   each decoded once.  15c: one job reads ``emu://`` (phase 14's knobs)
   with the disk tier armed, cold, at ``TPQ_PREFETCH_DEPTH=0`` and at the
   default: 6a's units, ``remote_ranges_fetched`` the spans,
   ``ranges_coalesced`` the chunks less the spans, ``remote_bytes`` the
   spans' bytes and a disk hit a chunk on the job's stats; three rounds
   of the two depths in turns, the walls' medians and ranges printed.
   15d: ``ScanServer(plan_cache_mb=256)`` runs one scan twice from an
   empty plan cache, three rounds: the second job hits once a chunk;
   the walls' and ``plan_s``' medians and ranges printed.  15e: ``parquet_tool.main`` in this process:
   ``verify`` (exit 0, K1-K5 and K7 launching), ``serve`` of a two-tenant
   spec with sink directories (exit 0, the unit files 6a's arrays),
   ``tenants`` on its status export and ``meta`` (exit 0).
16. The dataset writer, compaction and ``floor`` over config 2's rows
   (``check_dataset``, ``check_floor``).  16a: a ``DatasetWriter``
   writes config 2's row groups, one ``write_columns`` each, partitioned
   by ``rate_code`` (five values) at ``TPQ_DATASET_TARGET_MB=8`` and
   ``TPQ_PAGE_ROWS=65536``, and commits once: every manifest name is
   the SHA-1 of its file's bytes, and a ``DatasetScan`` on the card
   gives each partition's rows in write order, each file a run of its
   own partition's rows.  16b: a child (``python -c`` through
   ``dataset_child``, a timeout of its own) keeps a spare writer's
   partial open and commits one more row group, SIGKILLing itself at
   the first promote: a scan then sees 16a's rows, ``resume_from=``
   publishes v2, a scan sees both, each once, and ``sweep_orphans``
   moves the dead child's partial to ``_quarantine/``.  16c:
   ``parquet_tool compact --sort-by trip_distance_mm --keep 1`` in a
   subprocess prints the reference's lines (the old files as ``gc``
   lines); the new snapshot holds each partition's rows stably sorted;
   ``trip_distance_mm < 2000`` scans before and after equal the
   generator's survivors with ``pages_pruned`` (and the other pruning
   counters) worked out from the page index; ``rate_code == 3`` prunes
   the other partitions' files.  16d: 1,000,000 rows as ``Trip``
   objects through ``floor.Writer.write_columns`` in four row groups,
   read on the card against the generator; ``floor.Reader``'s first
   10,000 objects, and ``write_many``'s columns against the columnar
   path's.  Each read must launch K1-K4, and K5 and K7 where its
   routing counters say a page took byte planes or delta lanes.
17. The lock-order recorder and the port's analyzer over config 2's file
   (``check_lockcheck``).  17a: a child (``--lockcheck-child``, a
   timeout of its own) under ``TPQ_LOCKCHECK=strict``,
   ``TPQ_LOCKCHECK_OUT`` and ``TPQ_PROFILE=1`` reads config 2 at 8 plan
   workers (best of 3 passes), runs a ``ShardedScan`` of it over
   ``emu://`` with the disk tier (``PHASE14_EMU_KNOBS``) and one
   ``ScanServer`` job at ``TPQ_PREFETCH_DEPTH=2``, each checked against
   the generator and launching K1-K5 and K7.  The dump must hold no
   violation and a ``tpuparquet_torch/`` site, and ``python -m
   tpuparquet_torch.analyze --verify-lockcheck`` must find it a subgraph
   of the static lock graph.  The recorded sites and edges, the
   profiler's ``[lock-wait <site>]`` samples by site, and the armed
   pass's wall beside the same pass unarmed in this process are printed.
   17b: ``parquet_tool analyze --json`` exits 0 with 0 findings.

Before phase 1 it prints the card's name and power limit (as
``nvidia-smi --query-gpu=name,power.limit`` gives them), the host's
usable CPU count (``os.sched_getaffinity``), which bounds host planning,
and the codec backends (``codec_backends``: where libz and libzstd were
loaded from, the ``zstandard`` wheel, the build of ``csrc/lz4raw.c``); a
codec with no backend fails the run.
``read_kernel_splits``, ``encode_kernel_splits``,
``shard_kernel_splits`` and ``bss_kernel_splits`` time K1, K2, K4, K5,
KE1, KE5, KS2, KS3 and K12 alone at phase 4's shapes (K1 also at widths
3, 13 and 32, K2 also on a run-dense stream, KE1 on the ts page's
largest and smallest width classes and at widths 1, 7, 33 and 64, KE5
also on an int32 page, K12 on the sensor table's reading and temp
pages, k 6, 16 and 1,031, the reading page from a view 5 bytes in and
with the L2 flushed); they call only the kernels' wrappers, so loaded
from this file by path they time another checkout's kernels.
``encode_variants`` and ``bss_variants`` build this checkout's KE1, KE5
and K12 sources with one constant or one block of code changed (the
designs they left behind) and time them beside the kernels as built,
K12 also at other tile sizes.
``read_passes`` reads four of the files a few times on the host clock,
for an A/B of another checkout's read passes in the same way, and
``single_reads`` config 2 one row group a call (``read_row_group_device``);
``host_gathers`` times phase 6's gathers onto the host likewise, and
``multihost_ab`` phase 7c against one process's ``run()``, in turns.
Every kernel must have launched on the paths of phases 3 to 3i, 5, 5b,
6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16 and 17;
the counts are set to 0 just before each path's read or write and read
just after.  Exits non-zero, printing no result, when CUDA is
unavailable or any phase fails.  The last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``;
the line before it lists the kernels with their launches on the main
paths, times and bounds.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import datetime
import hashlib
import io
import json
import os
import socket
import subprocess
import sys
import tempfile
import threading
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from typing import Optional

import numpy as np
import torch

# NVIDIA H100 SXM data sheet: HBM3 rate, and the float32 rate outside the
# tensor cores (the listed rate closest to the kernels' integer work)
HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12

TRANSPORT_ENV = ("TPQ_DEVICE_SNAPPY", "TPQ_DEVICE_PLANES", "TPQ_DEVICE_DELTA")

SCHEMA = """message taxi {
    required int64 pickup_ts;
    required int32 passenger_count;
    required int32 rate_code;
    required int64 trip_distance_mm;
    optional int32 payment_type;
}"""

MIX_SCHEMA = """message mix {
    required int64 tok;
    optional int64 tok_opt;
    required int32 seq32;
    required int64 wide_delta;
    required int64 lanes_raw;
}"""


CONFIG4_SCHEMA = """message m {
    required binary vendor (STRING);
    required double fare;
    required double tip;
    optional binary note (STRING);
}"""

STRINGS_SCHEMA = """message strings {
    required binary url (STRING);
    optional binary url_opt (STRING);
    optional binary token (STRING);
}"""

CONFIG3_SCHEMA = """message m {
    optional group events (LIST) {
        repeated group list {
            optional int64 element (TIMESTAMP(MILLIS, true));
        }
    }
}"""

SENSORS_SCHEMA = """message sensors {
    required int64 ts (TIMESTAMP(MICROS, true));
    optional int32 seq;
    required float temp;
    optional double reading;
}"""

SPARK_SCHEMA = """message spark_schema {
    required int96 event_ts;
    required int96 load_date;
    optional boolean is_member;
    optional fixed_len_byte_array(16) amount (DECIMAL(38, 18));
    required fixed_len_byte_array(16) id (UUID);
}"""

MR_V2_SCHEMA = """message mr_v2 {
    required boolean flag;
    optional boolean opt_in;
    required binary url (STRING);
    required binary session (STRING);
    required fixed_len_byte_array(16) amount (DECIMAL(38, 9));
    required binary note;
}"""


def _write(schema: str, groups, optional, data_page_v2: bool = False,
           column_encodings=None, lists=None, codec: str = "SNAPPY",
           encode_threads=None, allow_dict: bool = True, **opts) -> bytes:
    """Write ``[(columns, masks)]`` with the port's writer (``codec``,
    SNAPPY by default; ``encode_threads`` None: the writer's default;
    ``opts`` the writer's other options); ``masks`` is one optional
    column's mask (``optional`` names it) or a dict of them (``optional``
    None).  ``lists`` gives each row group's ``(offsets,
    element_masks)`` of its LIST columns."""
    from tpuparquet_torch.format.metadata import CompressionCodec
    from tpuparquet_torch.io.writer import FileWriter

    buf = io.BytesIO()
    w = FileWriter(buf, schema, codec=CompressionCodec[codec],
                   data_page_v2=data_page_v2,
                   column_encodings=column_encodings,
                   encode_threads=encode_threads, allow_dict=allow_dict,
                   **opts)
    for i, (cols, mask) in enumerate(groups):
        offs, elem = lists[i] if lists is not None else (None, None)
        w.write_columns(cols, masks=mask if optional is None
                        else {optional: mask}, offsets=offs,
                        element_masks=elem)
    w.close()
    return buf.getvalue()


def build_config2(n_values: int, n_groups: int, seed: int = 42):
    """The config-2 file of bench.py (build_config2), written with the
    port's writer.  Returns (file bytes, [(columns, payment mask)])."""
    groups = config2_groups(n_values, n_groups, seed)
    return _write(SCHEMA, groups, "payment_type"), groups


def config2_groups(n_values: int, n_groups: int, seed: int = 42):
    """Config 2's row groups, ``[(columns, payment mask)]``."""
    rng = np.random.default_rng(seed)
    per = n_values // 5 // n_groups
    base_ts = 1_700_000_000_000
    groups = []
    for _ in range(n_groups):
        pay_mask = rng.random(per) >= 0.05
        cols = {
            "pickup_ts": base_ts
            + rng.integers(0, 3_600_000, size=per).cumsum(),
            "passenger_count": rng.integers(1, 7, size=per, dtype=np.int32),
            "rate_code": rng.integers(1, 6, size=per, dtype=np.int32),
            "trip_distance_mm": rng.integers(100, 50_000, size=per),
            "payment_type": rng.integers(
                0, 5, size=int(pay_mask.sum()), dtype=np.int32),
        }
        groups.append((cols, pay_mask))
    return groups


def build_mix(n_values: int, n_groups: int, seed: int = 11):
    """The transport mix, SNAPPY, written with the port's writer:
    ``tok`` (blocks of 64 random int64 in [-2^62, 2^62), each block
    repeated 4 times: snappy tokens), ``tok_opt`` (the same under a
    5%-null mask: tokens from a byte offset past the levels), ``seq32``
    (a slow int32 sequence: delta lanes at width 7), ``wide_delta``
    (delta lanes at width 39, the three-word unpack) and ``lanes_raw``
    (a random low word under a slowly stepping high word: byte planes).
    Returns (file bytes, [(columns, tok_opt mask)])."""
    rng = np.random.default_rng(seed)
    rows = n_values // 5 // n_groups
    groups = []
    for _ in range(n_groups):
        blocks = rng.integers(-2**62, 2**62, size=(-(-rows // 256), 64))
        tok = np.repeat(blocks, 4, axis=0).reshape(-1)[:rows]
        mask = rng.random(rows) >= 0.05
        cols = {
            "tok": tok,
            "tok_opt": tok[mask],
            "seq32": (rng.integers(0, 100, size=rows).cumsum() - 2**31
                      + 5).astype(np.int32),
            "wide_delta": rng.integers(0, 2**39, size=rows).cumsum()
            - 2**60,
            "lanes_raw": rng.integers(0, 2**32, size=rows)
            + ((np.arange(rows) // 100_000) << 32),
        }
        groups.append((cols, mask))
    return _write(MIX_SCHEMA, groups, "tok_opt"), groups


def _bytes_col(choices, picks):
    """``(offsets, data)`` of the vocabulary strings at ``picks``, gathered
    vectorised (bench.py build_config4's ``bytes_col``)."""
    cb = np.frombuffer(b"".join(choices), dtype=np.uint8)
    co = np.zeros(len(choices) + 1, dtype=np.int64)
    np.cumsum([len(c) for c in choices], out=co[1:])
    lens = (co[1:] - co[:-1])[picks]
    offs = np.zeros(len(picks) + 1, dtype=np.int64)
    np.cumsum(lens, out=offs[1:])
    pos = (np.arange(int(offs[-1]), dtype=np.int64)
           - np.repeat(offs[:-1], lens) + np.repeat(co[:-1][picks], lens))
    return offs, cb[pos]


def config4_groups(per: int, n_groups: int, seed: int = 4):
    """bench.py build_config4's generator: ``[(columns, {"note": mask})]``
    with each string column as ``(offsets, data)``."""
    rng = np.random.default_rng(seed)
    vocab = [f"vendor-{i:03d}".encode() for i in range(200)]
    notes = [f"note text {i}".encode() for i in range(50)]
    groups = []
    for _ in range(n_groups):
        note_mask = rng.random(per) >= 0.4
        n_notes = int(note_mask.sum())
        cols = {
            "vendor": _bytes_col(vocab, rng.integers(0, len(vocab),
                                                     size=per)),
            "fare": rng.random(per) * 100.0,
            "tip": rng.random(per) * 20.0,
            "note": _bytes_col(notes, rng.integers(0, len(notes),
                                                   size=n_notes)),
        }
        groups.append((cols, {"note": note_mask}))
    return groups


_URL_HEAD = b"https://data.example.org/nyc/yellow/2024/trips/by-vendor/" \
    b"pickup-zone/"
_URL_TAIL = b"/details.json"


def strings_groups(rows: int, n_groups: int, seed: int = 13):
    """The string mix: ``url`` (``_URL_HEAD + %09d of 7 i + _URL_TAIL``,
    ``i`` running over the whole file), ``url_opt`` (the same under a
    10%-null mask) and ``token`` (16 lowercase hex digits of random
    bytes under another 10%-null mask), each as ``(offsets, data)``,
    built as byte matrices.  Returns ``[(columns, masks)]``."""
    rng = np.random.default_rng(seed)
    width = len(_URL_HEAD) + 9 + len(_URL_TAIL)
    hexd = np.frombuffer(b"0123456789abcdef", dtype=np.uint8)
    groups = []
    for g in range(n_groups):
        num = 7 * np.arange(g * rows, (g + 1) * rows, dtype=np.int64)
        url = np.empty((rows, width), dtype=np.uint8)
        url[:, : len(_URL_HEAD)] = np.frombuffer(_URL_HEAD, np.uint8)
        for k in range(9):
            url[:, len(_URL_HEAD) + k] = 48 + (num // 10 ** (8 - k)) % 10
        url[:, len(_URL_HEAD) + 9 :] = np.frombuffer(_URL_TAIL, np.uint8)
        url_mask = rng.random(rows) >= 0.1
        tok_mask = rng.random(rows) >= 0.1
        raw = rng.integers(0, 256, size=(int(tok_mask.sum()), 8),
                           dtype=np.uint8)
        tok = np.stack([hexd[raw >> 4], hexd[raw & 15]], axis=2)

        def col(m):
            return (np.arange(m.shape[0] + 1, dtype=np.int64) * m.shape[1],
                    m.reshape(-1))

        groups.append(({"url": col(url), "url_opt": col(url[url_mask]),
                        "token": col(tok.reshape(-1, 16))},
                       {"url_opt": url_mask, "token": tok_mask}))
    return groups


def _port_columns(groups):
    """The generators' ``(offsets, data)`` string columns as the port's
    ByteArrayColumn."""
    from tpuparquet_torch.cpu.plain import ByteArrayColumn

    return [({k: ByteArrayColumn(*v) if isinstance(v, tuple) else v
              for k, v in cols.items()}, masks) for cols, masks in groups]


def build_config4(n_values: int, n_groups: int):
    """The config-4 file of bench.py (build_config4: DataPage V2, SNAPPY),
    written with the port's writer.  Returns (file bytes, groups)."""
    groups = _port_columns(config4_groups(n_values // 4 // n_groups,
                                          n_groups))
    return _write(CONFIG4_SCHEMA, groups, None, data_page_v2=True), groups


def build_strings(n_values: int, n_groups: int):
    """The string mix, V1, SNAPPY, ``max(n_values // 200, 200_000)`` rows
    a row group, written with the port's writer.  Returns (file bytes,
    groups)."""
    groups = _port_columns(strings_groups(max(n_values // 200, 200_000),
                                          n_groups))
    return _write(STRINGS_SCHEMA, groups, None), groups


def config3_groups(rows: int, n_groups: int, seed: int = 3):
    """bench.py build_config3's generator (the nullable LIST of
    timestamps): ``[(columns, masks, offsets, element_masks)]``, each
    keyed ``events``."""
    rng = np.random.default_rng(seed)
    base_ts = 1_600_000_000_000
    groups = []
    for _ in range(n_groups):
        lens = rng.integers(0, 8, size=rows)
        row_mask = rng.random(rows) >= 0.03      # 3% null rows
        lens[~row_mask] = 0                       # null rows are empty
        offs = np.zeros(rows + 1, dtype=np.int64)
        np.cumsum(lens, out=offs[1:])
        elem_mask = rng.random(int(offs[-1])) >= 0.02  # 2% null elements
        ts = base_ts + rng.integers(0, 60_000,
                                    size=int(elem_mask.sum())).cumsum()
        groups.append(({"events": ts}, {"events": row_mask},
                       {"events": offs}, {"events": elem_mask}))
    return groups


def build_config3(n_values: int, n_groups: int, data_page_v2: bool = False):
    """The config-3 file of bench.py (build_config3: DELTA_BINARY_PACKED
    int64 timestamps in a nullable LIST, SNAPPY, ``n_values // 3 //
    n_groups`` rows a group), written with the port's writer.  Returns
    (file bytes, groups)."""
    groups = config3_groups(n_values // 3 // n_groups, n_groups)
    blob = _write(CONFIG3_SCHEMA, [(c, m) for c, m, _, _ in groups], None,
                  data_page_v2=data_page_v2,
                  column_encodings={"events.list.element":
                                    _encoding("DELTA_BINARY_PACKED")},
                  lists=[(o, e) for _, _, o, e in groups])
    return blob, groups


def sensor_groups(rows: int, n_groups: int, seed: int = 17):
    """The sensor table's generator: bursty microsecond timestamps ``ts``
    (lognormal gaps, the base carried across row groups), an optional
    int32 sequence ``seq`` (10% nulls, geometric steps), a slow float
    ``temp`` walk and optional double ``reading``s (5% nulls).  Returns
    ``[(columns, masks)]``."""
    rng = np.random.default_rng(seed)
    base = 1_700_000_000_000_000
    groups = []
    for _ in range(n_groups):
        ts = base + np.cumsum(rng.lognormal(8.0, 2.5, rows).astype(np.int64))
        base = int(ts[-1])
        seq_mask = rng.random(rows) >= 0.1
        seq = np.cumsum(rng.geometric(0.3, int(seq_mask.sum()))).astype(
            np.int32)
        temp = (20 + np.cumsum(rng.normal(0, 0.05, rows))).astype(np.float32)
        reading_mask = rng.random(rows) >= 0.05
        reading = rng.normal(100, 15, int(reading_mask.sum()))
        groups.append(({"ts": ts, "seq": seq, "temp": temp,
                        "reading": reading},
                       {"seq": seq_mask, "reading": reading_mask}))
    return groups


SENSORS_ENCODINGS = {"ts": "DELTA_BINARY_PACKED",
                     "seq": "DELTA_BINARY_PACKED",
                     "temp": "BYTE_STREAM_SPLIT",
                     "reading": "BYTE_STREAM_SPLIT"}


def build_sensors(rows: int, n_groups: int, data_page_v2: bool = False):
    """The sensor table: ``ts`` and ``seq`` DELTA_BINARY_PACKED, ``temp``
    and ``reading`` BYTE_STREAM_SPLIT, SNAPPY, written with the port's
    writer.  Returns (file bytes, groups)."""
    groups = sensor_groups(rows, n_groups)
    return _write(SENSORS_SCHEMA, groups, None, data_page_v2=data_page_v2,
                  column_encodings=_encodings(SENSORS_ENCODINGS)), groups


# Julian day number of 2024-01-01, and the nanoseconds of a day: an INT96
# timestamp is the nanoseconds of its day (a little-endian int64) then the
# Julian day (a little-endian int32), as Spark and Impala write it
_JULIAN_2024 = 2_460_311
_NANOS_PER_DAY = 86_400 * 10**9


def _int96(days: np.ndarray, nanos: np.ndarray) -> np.ndarray:
    """INT96 timestamps as ``(N, 3)`` u32 words."""
    n = nanos.astype(np.uint64)
    out = np.empty((days.size, 3), dtype=np.uint32)
    out[:, 0] = n & np.uint64(0xFFFFFFFF)
    out[:, 1] = n >> np.uint64(32)
    out[:, 2] = days
    return out


def _be_rows(hi: np.ndarray, lo: np.ndarray) -> np.ndarray:
    """16-byte big-endian two's complement rows of ``hi * 2^64 + lo``
    (``hi`` int64, ``lo`` uint64): the DECIMAL form of a
    fixed_len_byte_array(16)."""
    out = np.empty((hi.size, 16), dtype=np.uint8)
    out[:, :8] = hi.astype(">i8").view(np.uint8).reshape(-1, 8)
    out[:, 8:] = lo.astype(">u8").view(np.uint8).reshape(-1, 8)
    return out


def spark_groups(rows: int, n_groups: int, seed: int = 19):
    """The Spark-style table's generator: ``event_ts`` (INT96 event
    times about 10 ms apart from 2024-01-01, rolling over midnight into
    the next Julian day), ``load_date`` (INT96 midnights of 30 days),
    ``is_member`` (10% nulls), ``amount`` (DECIMAL(38, 18) as 16-byte
    big-endian two's complement below 2^94 in magnitude, 5% nulls) and
    ``id`` (random 16-byte UUIDs).  Returns ``[(columns, masks)]``."""
    rng = np.random.default_rng(seed)
    midnights = _int96(_JULIAN_2024 + np.arange(30), np.zeros(30, np.int64))
    t = 0
    groups = []
    for _ in range(n_groups):
        ns = t + np.cumsum(rng.integers(1, 20_000_000, size=rows))
        t = int(ns[-1])
        member_mask = rng.random(rows) >= 0.1
        amount_mask = rng.random(rows) >= 0.05
        k = int(amount_mask.sum())
        cols = {
            "event_ts": _int96(_JULIAN_2024 + ns // _NANOS_PER_DAY,
                               ns % _NANOS_PER_DAY),
            "load_date": midnights[rng.integers(0, 30, size=rows)],
            "is_member": rng.random(int(member_mask.sum())) < 0.35,
            "amount": _be_rows(rng.integers(-2**30, 2**30, size=k),
                               rng.integers(0, 2**63, size=k,
                                            dtype=np.uint64) * 2),
            "id": rng.integers(0, 256, size=(rows, 16), dtype=np.uint8),
        }
        groups.append((cols, {"is_member": member_mask,
                              "amount": amount_mask}))
    return groups


def build_spark(n_values: int, n_groups: int):
    """The Spark-style table: V1, SNAPPY, ``n_values // 5 // n_groups``
    rows a group, every column as the writer's defaults leave it (PLAIN,
    or dictionary where it pays), as parquet-mr V1 writes a Spark table.
    Returns (file bytes, groups)."""
    groups = spark_groups(n_values // 5 // n_groups, n_groups)
    return _write(SPARK_SCHEMA, groups, None), groups


_SHOP = b"https://shop.example.com/catalog/"
_NOTES = [b"ok", b"late", b"gift wrap", b"leave at door", b"call first",
          b"fragile", b"", b"returned", b"second attempt", b"signed"]


def _with_digits(prefix, digits: np.ndarray):
    """``(offsets, data)`` of each prefix string followed by its row of
    ASCII digits."""
    p_offs, p_data = prefix
    lp = np.diff(p_offs)
    offs = np.zeros(lp.size + 1, dtype=np.int64)
    np.cumsum(lp + digits.shape[1], out=offs[1:])
    data = np.empty(int(offs[-1]), dtype=np.uint8)
    dst = (np.arange(p_data.size, dtype=np.int64)
           - np.repeat(p_offs[:-1], lp) + np.repeat(offs[:-1], lp))
    data[dst] = p_data
    data[(offs[:-1] + lp)[:, None] + np.arange(digits.shape[1])] = digits
    return offs, data


def mr_v2_groups(rows: int, n_groups: int, seed: int = 23):
    """The parquet-mr v2 table's generator: ``flag`` (runs of 100-5,000
    equal booleans), ``opt_in`` (20% nulls), ``url`` (sorted: 64 catalog
    paths, then a 9-digit item number rising through the file),
    ``session`` (32 random hex digits), ``amount`` (DECIMAL(38, 9) below
    2^40 as 16-byte big-endian rows: at least 11 shared leading zero
    bytes) and ``note`` (short strings), strings as ``(offsets, data)``.
    Returns ``[(columns, masks)]``."""
    rng = np.random.default_rng(seed)
    paths = [_SHOP + b"dept-%02d/%s/item-" % (c, b"x" * (c % 9))
             for c in range(64)]
    hexd = np.frombuffer(b"0123456789abcdef", dtype=np.uint8)
    groups = []
    for g in range(n_groups):
        runs = rng.integers(100, 5_000, size=rows // 100 + 1)
        flag = np.repeat(np.arange(runs.size) % 2 == 0, runs)[:rows]
        opt_mask = rng.random(rows) >= 0.2
        item = np.arange(g * rows, (g + 1) * rows, dtype=np.int64)
        digits = (48 + (item[:, None] // 10 ** np.arange(8, -1, -1)) % 10
                  ).astype(np.uint8)
        raw = rng.integers(0, 256, size=(rows, 16), dtype=np.uint8)
        session = np.stack([hexd[raw >> 4], hexd[raw & 15]], axis=2)
        cols = {
            "flag": flag,
            "opt_in": rng.random(int(opt_mask.sum())) < 0.6,
            "url": _with_digits(_bytes_col(
                paths, np.sort(rng.integers(0, 64, size=rows))), digits),
            "session": (np.arange(rows + 1, dtype=np.int64) * 32,
                        session.reshape(-1)),
            "amount": _be_rows(np.zeros(rows, np.int64),
                               rng.integers(0, 2**40, size=rows,
                                            dtype=np.uint64)),
            "note": _bytes_col(_NOTES, rng.integers(0, len(_NOTES),
                                                    size=rows)),
        }
        groups.append((cols, {"opt_in": opt_mask}))
    return groups


MR_V2_ENCODINGS = {"flag": "RLE", "opt_in": "RLE",
                   "url": "DELTA_BYTE_ARRAY", "session": "DELTA_BYTE_ARRAY",
                   "amount": "DELTA_BYTE_ARRAY",
                   "note": "DELTA_LENGTH_BYTE_ARRAY"}


def build_mr_v2(n_values: int, n_groups: int):
    """The parquet-mr v2 table: data page V2, SNAPPY, ``n_values * 4 //
    25 // n_groups`` rows a group (48,000,000 slots at 50,000,000), each
    column in the encoding parquet-mr's ``DefaultV2ValuesWriterFactory``
    picks for its type (RLE booleans, DELTA_BYTE_ARRAY binary and
    fixed-length columns; ``note`` DELTA_LENGTH_BYTE_ARRAY).  Returns
    (file bytes, groups)."""
    groups = _port_columns(mr_v2_groups(n_values * 4 // 25 // n_groups,
                                        n_groups))
    enc = {k: _encoding(v) for k, v in MR_V2_ENCODINGS.items()}
    return _write(MR_V2_SCHEMA, groups, None, data_page_v2=True,
                  column_encodings=enc), groups


def _encoding(name: str):
    from tpuparquet_torch.format.metadata import Encoding

    return Encoding[name]


def _encodings(names: dict) -> dict:
    return {k: _encoding(v) for k, v in names.items()}


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy().view(np.uint32).astype(np.int64)


def _same(name: str, got: torch.Tensor, want: torch.Tensor) -> int:
    """Bit-exact compare; returns the max abs difference (0)."""
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} vs "
                             f"{tuple(want.shape)}")
    a, b = got.cpu().numpy(), want.cpu().numpy()
    if a.dtype != b.dtype or not np.array_equal(a, b):
        if a.dtype == np.int32:
            a, b = a.view(np.uint32).astype(np.int64), \
                b.view(np.uint32).astype(np.int64)
        raise AssertionError(
            f"{name}: kernel disagrees with its plain version "
            f"(max abs diff {int(np.abs(a.astype(np.int64) - b).max())})")
    return 0


def _stream(values: np.ndarray, width: int, dev):
    """Hybrid-encode ``values`` and stage its run table as the planner
    would (table mode): ((bp words, table) on ``dev``, cnt, nbp)."""
    from tpuparquet_torch.cpu.hybrid import encode_hybrid, scan_hybrid
    from tpuparquet_torch.kernels.hybrid import pack_plan, plan_from_scan

    sc = scan_hybrid(encode_hybrid(values, width), values.size, width)
    (bp, tbl), cnt, _, nbp = pack_plan(plan_from_scan(sc, values.size,
                                                      width))
    return (torch.from_numpy(bp.view(np.int32)).to(dev),
            torch.from_numpy(tbl.reshape(-1).view(np.int32)).to(dev),
            cnt, nbp)


def _one_run(values: np.ndarray, width: int, cnt: int, dev):
    """``values`` as one bit-packed run covering ``cnt`` lanes."""
    from tpuparquet_torch.cpu.bitpack import pack
    from tpuparquet_torch.kernels.bitunpack import pad_to_words

    words = pad_to_words(np.frombuffer(pack(values, width), np.uint8),
                         width, cnt)
    return torch.from_numpy(words.reshape(-1).view(np.int32)).to(dev)


def _runny(rng, n: int, width: int) -> np.ndarray:
    """Values with long constant stretches mixed into random ones."""
    hi = (1 << width) - 1
    v = rng.integers(0, hi, size=n, endpoint=True, dtype=np.uint64)
    for _ in range(max(n // 200, 1)):
        a = int(rng.integers(0, n))
        v[a : a + int(rng.integers(8, 200))] = rng.integers(0, hi + 1)
    return v


def _t(a: np.ndarray, dev) -> torch.Tensor:
    """A numpy array as a 1-D tensor on ``dev`` (4-byte dtypes as int32
    bits, bytes as uint8)."""
    a = np.ascontiguousarray(a).reshape(-1)
    a = a.view(np.uint8 if a.dtype.itemsize == 1 else np.int32)
    return torch.from_numpy(a.copy()).to(dev)


def _run_table(rng, count: int, n_runs: int, dtype, cuts=None):
    """A bucket-padded run table, as the plane planner stages it: int32
    ends (padding = count) and values (padding = 0); the runs end at
    ``cuts`` (sorted, below count) when given, else at random."""
    from tpuparquet_torch.kernels.decode import bucket

    if cuts is None:
        cuts = np.sort(rng.choice(np.arange(1, count), size=n_runs - 1,
                                  replace=False)).astype(np.int32)
    n_runs = cuts.size + 1
    cap = bucket(n_runs)
    ends = np.full(cap, count, dtype=np.int32)
    ends[: n_runs - 1] = cuts
    vals = np.zeros(cap, dtype=dtype)
    vals[:n_runs] = rng.integers(0, np.iinfo(dtype).max, size=n_runs,
                                 endpoint=True, dtype=dtype)
    return ends, vals, cap


def _check_planes(rng, dev) -> None:
    from tpuparquet_torch.kernels.decode import planes_to_words, \
        planes_to_words_plain

    count = 5003
    raw32 = rng.integers(0, 2**32, size=2 * count, dtype=np.uint32)
    raw8 = rng.integers(0, 256, size=3 * count, dtype=np.uint8)
    e32a, v32a, c32a = _run_table(rng, count, 7, np.uint32)
    e32b, v32b, c32b = _run_table(rng, count, 40, np.uint32)
    e8a, v8a, c8a = _run_table(rng, count, 3, np.uint8)
    e8b, v8b, c8b = _run_table(rng, count, 300, np.uint8)
    bufs = [raw32, np.concatenate([e32a, e32b]), np.concatenate([v32a, v32b]),
            raw8, np.concatenate([e8a, e8b]), np.concatenate([v8a, v8b])]
    r32a, r32b = ("rle32", 0, c32a), ("rle32", c32a, c32b)
    r8a, r8b = ("rle8", 0, c8a), ("rle8", c8a, c8b)
    specs = [
        (1, (("raw32", 1),)),
        (1, (r32b,)),
        (1, (("bytes", ("raw8", 2), r8a, ("raw8", 0), r8b),)),
        (2, (r32a, ("raw32", 0))),
        (2, (("bytes", r8b, ("raw8", 1), r8a, r8a), r32b)),
        (2, (("raw32", 1), ("bytes", ("raw8", 0), ("raw8", 1), ("raw8", 2),
                             r8b))),
    ]
    dbufs = [_t(b, dev) for b in bufs]
    cbufs = [b.cpu() for b in dbufs]
    for lanes, spec in specs:
        _same(f"K5 {spec}", planes_to_words(*dbufs, spec, count, lanes),
              planes_to_words_plain(*cbufs, spec, count, lanes))


# K4 where its design has edges (T = decode.validity_tile_slots()): name
# -> (slots as a function of T, null share, max_def, words the def levels
# start into their buffer).  Sizes 1, 3, 4 and 5 (short of a lane's 4
# slots), T - 1, T and T + 1, 9 T + 3 (look-back over several tiles) and
# 2^21 + 3; all null and no nulls; max_def 1 and 3; views 1, 2 and 3
# words in (def levels off a 16-byte boundary).
LEVELS_EDGE_CASES = {
    "1 slot": (lambda t: 1, 0.3, 1, 0),
    "3 slots": (lambda t: 3, 0.3, 3, 0),
    "4 slots": (lambda t: 4, 0.3, 1, 0),
    "5 slots": (lambda t: 5, 0.3, 3, 0),
    "tile - 1": (lambda t: t - 1, 0.3, 1, 0),
    "tile": (lambda t: t, 0.3, 3, 0),
    "tile + 1": (lambda t: t + 1, 0.05, 1, 0),
    "9 tiles + 3": (lambda t: 9 * t + 3, 0.4, 3, 0),
    "2^21 + 3": (lambda t: (1 << 21) + 3, 0.05, 1, 0),
    "all null": (lambda t: 3 * t + 5, 1.0, 3, 0),
    "no nulls": (lambda t: 3 * t + 5, 0.0, 1, 0),
    "view 1 word in": (lambda t: 2 * t + 7, 0.3, 1, 1),
    "view 2 words in": (lambda t: 2 * t + 6, 0.3, 3, 2),
    "view 3 words in": (lambda t: 2 * t + 5, 0.5, 1, 3),
}


def levels_case(rng, name: str):
    """A K4 edge case (see LEVELS_EDGE_CASES): ``(buf, lead, max_def)``,
    the def levels being ``buf[lead:]`` (int32; a null slot's level is
    below max_def)."""
    from tpuparquet_torch.kernels.decode import validity_tile_slots

    n_fn, nulls, max_def, lead = LEVELS_EDGE_CASES[name]
    n = n_fn(validity_tile_slots())
    dl = np.where(rng.random(n) < nulls, rng.integers(0, max_def, size=n),
                  max_def).astype(np.int32)
    buf = np.concatenate([rng.integers(0, max_def + 1, size=lead,
                                       dtype=np.int32), dl])
    return buf, lead, max_def


def _dirty(dev, nbytes: int) -> None:
    """Leave a freed block of ``nbytes`` garbage in the caching allocator,
    which the next allocation of that size takes: a kernel that leaves a
    word of its output unwritten then disagrees with its plain version."""
    if dev.type == "cuda":
        torch.full((nbytes,), 0xA5, dtype=torch.uint8, device=dev)


def _check_levels_edges(rng, dev, names=None) -> None:
    """K4 against its plain version over the whole output on
    LEVELS_EDGE_CASES, each output allocated over garbage."""
    from tpuparquet_torch.kernels.decode import levels_to_validity, \
        levels_to_validity_plain, validity_tile_slots

    for name in names or LEVELS_EDGE_CASES:
        buf, lead, max_def = levels_case(rng, name)
        dl = _t(buf, dev)[lead:]
        n = dl.numel()
        _dirty(dev, -(-5 * n // 8) * 8 + 8 * -(-n // validity_tile_slots()))
        m, p = levels_to_validity(dl, max_def)
        pm, pp = levels_to_validity_plain(dl.cpu(), max_def)
        _same(f"K4 {name} mask", m, pm)
        _same(f"K4 {name} positions", p, pp)


# K5 where its design has edges (T = decode.planes_tile_values()): name ->
# (count as a function of T, the spec's lanes, whether every table slice
# starts past 0, whether every buffer is a view off a 16-byte boundary).
# A lane is ("raw32", slab), ("rle32", runs) or ("bytes", 4 planes), a
# plane ("raw8", slab) or ("rle8", runs); runs are a count, "one" (one
# run over the page), "unit" (runs of length 1) or "edge" (run ends on
# every tile edge).  Raw slabs 1-3 start at every offset mod 4 when the
# count is not a multiple of 4; "runs of length 1" meets more runs a tile
# than a block stages.
PLANES_EDGE_CASES = {
    "count 1024": (lambda t: 1024, (
        ("bytes", ("raw8", 1), ("raw8", 2), ("rle8", "one"),
         ("rle8", "one")), ("rle32", "one")), False, False),
    "count 1025": (lambda t: 1025, (
        ("raw32", 1), ("bytes", ("raw8", 1), ("raw8", 2), ("raw8", 3),
                       ("rle8", 40))), True, False),
    "count 1027": (lambda t: 1027, (
        ("raw32", 2), ("raw32", 3), ("bytes", ("raw8", 3), ("rle8", 10),
                                     ("raw8", 1), ("raw8", 2))), True, True),
    "tile - 1": (lambda t: t - 1, (
        ("bytes", ("raw8", 1), ("raw8", 2), ("rle8", "edge"),
         ("rle8", 3)),), False, True),
    "tile": (lambda t: t, (
        ("raw32", 1), ("rle32", 50), ("bytes", ("rle8", 9), ("raw8", 3),
                                      ("raw8", 2), ("rle8", "one")),
        ("raw32", 3)), True, False),
    "tile + 1": (lambda t: t + 1, (("rle32", 7), ("raw32", 1)), False,
                 True),
    "2^20 + 3": (lambda t: (1 << 20) + 3, (
        ("bytes", ("raw8", 1), ("raw8", 2), ("rle8", 300), ("rle8", "one")),
        ("rle32", 1000)), True, True),
    "runs of length 1": (lambda t: 3 * t + 5, (
        ("rle32", "unit"), ("rle32", "unit"),
        ("bytes", ("rle8", "unit"), ("rle8", "unit"), ("raw8", 1),
         ("rle8", "unit")), ("rle32", "unit")), True, False),
    "one run over the page": (lambda t: 5000, (
        ("bytes", ("rle8", "one"), ("rle8", "one"), ("rle8", "one"),
         ("rle8", "one")), ("rle32", "one")), False, False),
    "run ends on tile edges": (lambda t: 3 * t + 1, (
        ("rle32", "edge"), ("bytes", ("rle8", "edge"), ("raw8", 1),
                            ("rle8", "edge"), ("rle8", "unit"))), True,
                               True),
}


def _edge_table(rng, count: int, runs, dtype):
    """A bucket-padded run table with ``runs`` runs (see
    PLANES_EDGE_CASES)."""
    from tpuparquet_torch.kernels.decode import planes_tile_values

    if runs == "edge":
        t = planes_tile_values()
        cuts = np.unique(np.concatenate([
            np.arange(t, count, t),
            rng.choice(np.arange(1, count), size=min(20, count - 1),
                       replace=False)]))
        return _run_table(rng, count, 0, dtype, cuts)
    return _run_table(rng, count, {"one": 1, "unit": count}.get(runs, runs),
                      dtype)


# words (4-byte buffers) or bytes (uint8 buffers) each buffer starts into
# its view in a case of PLANES_EDGE_CASES that asks for views
_PLANE_VIEW_LEADS = (1, 2, 3, 3, 1, 1)


def planes_case(rng, name: str):
    """A K5 edge case (see PLANES_EDGE_CASES): ``(bufs, leads, spec,
    count, lanes)``, the six buffers of planes_to_words (raw32, rle32
    ends and values, raw8, rle8 ends and values) being ``bufs[k][leads[k]:]``
    (numpy, u32 words as uint32)."""
    from tpuparquet_torch.kernels.decode import planes_tile_values

    count_fn, lanes_t, past0, views = PLANES_EDGE_CASES[name]
    count = count_fn(planes_tile_values())
    tables = {32: ([], [], 0), 8: ([], [], 0)}

    def table(runs, bits):
        ends_l, vals_l, start = tables[bits]
        dtype = np.uint32 if bits == 32 else np.uint8
        if past0 and start == 0:  # a table of another page first
            e, v, cap = _edge_table(rng, 64, 5, dtype)
            ends_l.append(e)
            vals_l.append(v)
            start = cap
        e, v, cap = _edge_table(rng, count, runs, dtype)
        ends_l.append(e)
        vals_l.append(v)
        tables[bits] = (ends_l, vals_l, start + cap)
        return start, cap

    spec = []
    for lane in lanes_t:
        if lane[0] == "raw32":
            spec.append(lane)
        elif lane[0] == "rle32":
            spec.append(("rle32", *table(lane[1], 32)))
        else:
            spec.append(("bytes", *(
                sub if sub[0] == "raw8" else ("rle8", *table(sub[1], 8))
                for sub in lane[1:])))

    def cat(parts, dtype):
        return np.concatenate(parts) if parts else np.zeros(1, dtype)

    bufs = [rng.integers(0, 2**32, size=4 * count, dtype=np.uint32),
            cat(tables[32][0], np.int32), cat(tables[32][1], np.uint32),
            rng.integers(0, 256, size=4 * count, dtype=np.uint8),
            cat(tables[8][0], np.int32), cat(tables[8][1], np.uint8)]
    leads = _PLANE_VIEW_LEADS if views else (0,) * 6
    bufs = [np.concatenate([rng.integers(0, 200, size=k, dtype=b.dtype), b])
            for b, k in zip(bufs, leads)]
    return bufs, leads, tuple(spec), count, len(lanes_t)


def _check_planes_edges(rng, dev, names=None) -> None:
    """K5 against its plain version over the whole output on
    PLANES_EDGE_CASES, each output allocated over garbage."""
    from tpuparquet_torch.kernels.decode import planes_to_words, \
        planes_to_words_plain

    for name in names or PLANES_EDGE_CASES:
        bufs, leads, spec, count, lanes = planes_case(rng, name)
        dbufs = [_t(b, dev)[k:] for b, k in zip(bufs, leads)]
        _dirty(dev, 4 * count * lanes)
        _same(f"K5 {name}", planes_to_words(*dbufs, spec, count, lanes),
              planes_to_words_plain(*(b.cpu() for b in dbufs), spec, count,
                                    lanes))


# K1 where its design has edges (T = bitunpack.unpack_tile_lanes()): name
# -> (widths, lanes as a function of T, words the packed stream starts
# into its buffer).  Counts 1, 3, 4 and 5 (around a thread's 4 lanes), 31,
# 32 and 33 (around a 32-lane block), T - 1, T, T + 1 and 3 T + 5; views
# 1, 2 and 3 words in (the words off a 16-byte boundary); 2^21 + 3 lanes
# at every width, on the card only.  Every stream ends exactly at
# ceil(count / 32) * width words, the end of its buffer.
UNPACK_WIDTHS = (0, 1, 2, 3, 7, 8, 13, 16, 17, 31, 32)
UNPACK_EDGE_CASES = {
    **{f"count {n}": (UNPACK_WIDTHS, lambda t, n=n: n, 0)
       for n in (1, 3, 4, 5, 31, 32, 33)},
    "tile - 1": (UNPACK_WIDTHS, lambda t: t - 1, 0),
    "tile": (UNPACK_WIDTHS, lambda t: t, 0),
    "tile + 1": (UNPACK_WIDTHS, lambda t: t + 1, 0),
    "3 tiles + 5": (UNPACK_WIDTHS, lambda t: 3 * t + 5, 0),
    "view 1 word in": (UNPACK_WIDTHS, lambda t: t + 37, 1),
    "view 2 words in": (UNPACK_WIDTHS, lambda t: 2 * t + 3, 2),
    "view 3 words in": (UNPACK_WIDTHS, lambda t: 3 * t + 1, 3),
    **{f"2^21 + 3 width {w}": ((w,), lambda t: (1 << 21) + 3, 0)
       for w in UNPACK_WIDTHS},
}


def unpack_case(rng, name: str) -> list:
    """A K1 edge case (see UNPACK_EDGE_CASES): ``[(width, buf, lead,
    count, values)]``, one a width, the packed words being ``buf[lead:]``
    (uint32, exactly ceil(count / 32) * width of them)."""
    from tpuparquet_torch.cpu.bitpack import pack
    from tpuparquet_torch.kernels.bitunpack import pad_to_words, \
        unpack_tile_lanes

    widths, count_fn, lead = UNPACK_EDGE_CASES[name]
    count = count_fn(unpack_tile_lanes())
    out = []
    for w in widths:
        vals = rng.integers(0, (1 << w) - 1 if w else 0, size=count,
                            endpoint=True, dtype=np.uint64)
        words = pad_to_words(np.frombuffer(pack(vals, w), np.uint8), w,
                             count).reshape(-1) if w else \
            np.zeros(0, np.uint32)
        buf = np.concatenate([rng.integers(0, 2**32, size=lead,
                                           dtype=np.uint32), words])
        out.append((w, buf, lead, count, vals))
    return out


def _check_unpack_edges(rng, dev, names=None) -> None:
    """K1 against its plain version and the generator over the whole
    output on UNPACK_EDGE_CASES, each output allocated over garbage."""
    from tpuparquet_torch.kernels.bitunpack import unpack_u32, \
        unpack_u32_plain

    for name in names or UNPACK_EDGE_CASES:
        for w, buf, lead, count, vals in unpack_case(rng, name):
            words = _t(buf, dev)[lead:]
            _dirty(dev, 4 * count)
            got = unpack_u32(words, w, count)
            _same(f"K1 {name} width {w}", got,
                  unpack_u32_plain(words.cpu(), w, count))
            if not np.array_equal(_u32(got), vals.astype(np.int64)):
                raise AssertionError(f"K1 {name} width {w}: wrong values")


# K2 where its design has edges (T = hybrid.hybrid_tile_slots()): name ->
# (layout, width, output slots as a function of T, whether the words and
# the table are views off 16-byte boundaries).  Layouts: rate_code's index
# stream (25 runs, 12 RLE, in a table of 32); one RLE run over the stream;
# one bit-packed run kept as a table; a run-dense width-1 stream (RLE runs
# of 1-8 slots between bit-packed runs of 8), whose tiles meet more runs
# than a block stages; run ends on every tile edge; runs of length 0; a
# table of exactly 32 runs without padding, whose last run is bit-packed
# and ends before the count, so the slots past it clamp past its lanes and
# past nbp; bit-packed runs whose bp_start + within passes nbp, or whose
# bp_start is negative; random runs ("mixed") at widths 0 (read at width
# 1), 1, 3, 8, 17 and 32 and counts 1, 5, T - 1, T + 1 and 2^21 + 3 (on
# the card only).
HYBRID_EDGE_CASES = {
    "rate_code shape": ("rate_code", 3, lambda t: 5000, False),
    "one RLE run": ("one rle", 8, lambda t: 3 * t + 5, False),
    "one bit-packed run": ("one bp", 17, lambda t: 2 * t + 3, True),
    "run-dense width 1": ("dense", 1, lambda t: 3 * t + 5, False),
    "run ends on tile edges": ("tile edges", 3, lambda t: 4 * t, False),
    "runs of length 0": ("zero", 8, lambda t: 2 * t + 1, True),
    "no padding runs": ("no padding", 32, lambda t: t + 37, False),
    "bp_start past nbp": ("past nbp", 17, lambda t: 2 * t + 9, True),
    "width 0": ("mixed", 0, lambda t: t + 1, False),
    "width 32": ("mixed", 32, lambda t: 3 * t + 5, True),
    "cnt 1": ("mixed", 3, lambda t: 1, False),
    "cnt 5": ("mixed", 1, lambda t: 5, True),
    "tile - 1": ("mixed", 17, lambda t: t - 1, False),
    "tile + 1": ("mixed", 8, lambda t: t + 1, True),
    "2^21 + 3": ("mixed", 3, lambda t: (1 << 21) + 3, True),
}


def _hybrid_runs(rng, layout: str, cnt: int, width: int, t: int):
    """The runs of a HYBRID_EDGE_CASES layout over ``cnt`` slots, in
    order: ``(is_rle, length, value)``; lengths may sum past ``cnt``."""
    hi = (1 << width) - 1

    def rle(n):
        return True, n, int(rng.integers(0, hi, endpoint=True))

    def cut(points, rle_first=False):
        ends = np.unique(np.concatenate([points, [cnt]]))
        lens = np.diff(ends, prepend=0)
        return [rle(int(n)) if (k % 2 == 0) == rle_first else
                (False, int(n), 0) for k, n in enumerate(lens)]

    if layout == "rate_code":  # 13 bit-packed runs around 12 RLE runs
        return cut(np.sort(rng.choice(np.arange(1, cnt), 24, replace=False)))
    if layout == "one rle":
        return [rle(cnt)]
    if layout == "one bp":
        return [(False, cnt, 0)]
    if layout == "tile edges":
        return cut(np.concatenate([np.arange(t, cnt, t), rng.integers(
            1, cnt, size=300)]), rle_first=True)
    if layout == "zero":  # runs of length 0 (repeated ends), one at slot 0
        runs = [rle(0)]
        for k, r in enumerate(cut(np.append(rng.integers(1, cnt, size=60),
                                            t))):
            runs += [r, rle(0) if k % 2 else (False, 0, 0)]
        return runs
    if layout == "no padding":  # 32 runs; the last is bit-packed and ends
        # 37 slots short of cnt
        runs = [rle(int(rng.integers(1, 40))) if k % 2 else
                (False, 8 * int(rng.integers(1, 6)), 0) for k in range(31)]
        return runs + [(False, cnt - 37 - sum(n for _, n, _ in runs), 0)]
    runs, total = [], 0
    while total < cnt:
        if layout == "dense":
            r = rle(int(rng.integers(1, 9))) if len(runs) % 2 else \
                (False, 8, 0)
        else:  # "mixed", "past nbp"
            r = rle(int(rng.integers(1, 300))) if len(runs) % 2 else \
                (False, 8 * int(rng.integers(1, 50)), 0)
        runs.append(r)
        total += r[1]
    return runs


def hybrid_case(rng, name: str):
    """A K2 edge case (see HYBRID_EDGE_CASES): ``(words_buf, words_lead,
    table_buf, table_lead, cnt, width, nbp)``: the bit-packed lanes are
    ``words_buf[words_lead:]`` (uint32, exactly ceil(nbp / 32) *
    max(width, 1) words, random bits) and the flat (4, R) run table
    ``table_buf[table_lead:]``, padded with RLE runs of 0 ending at cnt to
    a power-of-two R (at least 32) as the planner pads it."""
    from tpuparquet_torch.kernels.decode import bucket
    from tpuparquet_torch.kernels.hybrid import hybrid_tile_slots

    t = hybrid_tile_slots()
    layout, width, cnt_fn, views = HYBRID_EDGE_CASES[name]
    cnt = cnt_fn(t)
    runs = _hybrid_runs(rng, layout, cnt, width, t)
    lens = np.array([n for _, n, _ in runs], dtype=np.int64)
    is_rle = np.array([r for r, _, _ in runs], dtype=bool)
    ends = np.minimum(np.cumsum(lens), cnt)
    bp_lens = np.where(is_rle, 0, lens)
    bp_start = np.cumsum(bp_lens) - bp_lens
    nbp = max(int(bp_lens.sum()), 1)
    if layout == "past nbp":  # the last lanes are missing; one start < 0
        nbp = max(nbp - 50, 1)
        bp_start[np.flatnonzero(~is_rle)[1]] = -5
    R = len(runs) if layout == "no padding" else bucket(len(runs))
    table = np.zeros((4, R), dtype=np.uint32)
    table[0] = cnt
    table[0, : len(runs)] = ends
    table[1] = 1
    table[1, : len(runs)] = is_rle
    table[2, : len(runs)] = [v for _, _, v in runs]
    table[3, : len(runs)] = bp_start.astype(np.int32).view(np.uint32)
    words = rng.integers(0, 2**32, size=-(-nbp // 32) * max(width, 1),
                         dtype=np.uint32)
    wl, tl = (1, 3) if views else (0, 0)
    return (np.concatenate([rng.integers(0, 2**32, size=wl,
                                         dtype=np.uint32), words]), wl,
            np.concatenate([rng.integers(0, 2**32, size=tl,
                                         dtype=np.uint32),
                            table.reshape(-1)]), tl, cnt, width, nbp)


def _check_hybrid_edges(rng, dev, names=None) -> None:
    """K2 against its plain version over the whole output on
    HYBRID_EDGE_CASES, each output allocated over garbage."""
    from tpuparquet_torch.kernels.hybrid import expand_hybrid, \
        expand_hybrid_plain

    for name in names or HYBRID_EDGE_CASES:
        wbuf, wl, tbuf, tl, cnt, w, nbp = hybrid_case(rng, name)
        words, table = _t(wbuf, dev)[wl:], _t(tbuf, dev)[tl:]
        _dirty(dev, 4 * cnt)
        _same(f"K2 {name}", expand_hybrid(words, table, cnt, w, nbp),
              expand_hybrid_plain(words.cpu(), table.cpu(), cnt, w, nbp))


def _check_unpack_u64(rng, dev) -> None:
    from tpuparquet_torch.cpu.bitpack import pack
    from tpuparquet_torch.kernels.bitunpack import pad_to_words, \
        unpack_u64, unpack_u64_plain

    for n in (10_007, 45):
        for w in range(65):
            vals = (rng.integers(0, 2**63, size=n, dtype=np.uint64) * 2
                    + rng.integers(0, 2, size=n, dtype=np.uint64))
            if w < 64:
                vals &= np.uint64((1 << w) - 1)
            words = _t(pad_to_words(np.frombuffer(pack(vals, w), np.uint8),
                                    max(w, 1), n), dev)
            lo, hi = unpack_u64(words, w, n)
            plo, phi = unpack_u64_plain(words.cpu(), w, n)
            _same(f"K6 width {w} n {n} lo", lo, plo)
            _same(f"K6 width {w} n {n} hi", hi, phi)
            got = (_u32(lo).astype(np.uint64)
                   | (_u32(hi).astype(np.uint64) << np.uint64(32)))
            if not np.array_equal(got, vals):
                raise AssertionError(f"K6 width {w}: wrong values")


# K7's cases: (totals, block sizes, misaligned).  Its CTAs scan tiles of
# 4,096 positions in rows of 128 (csrc/delta_scan.cu); block size "n" is
# the whole stream's (n_deltas, 2^21 + 2 at the largest total); blocks
# under 128 take the kernel's division; "misaligned" reads dlo and dhi
# from views 1 and n + 3 words into their buffer, which the kernel loads
# as scalars
K7_CASES = {
    "sizes": ((1, 2, 1025, (1 << 21) + 3), ("n", 128), False),
    "tile edges": ((4095, 4096, 4097, 8192, 8193), (128, 256), False),
    "many tiles": ((37 * 4096 + 515,), (128, 256, "n"), False),
    "small blocks": ((5000,), (1, 3, 127), False),
    "misaligned dlo": ((4097, 100_003), (128, 256), True),
}


def _check_delta_scan(rng, dev, names=None) -> None:
    from tpuparquet_torch.kernels.decode import delta_scan, delta_scan_plain

    for name in names or K7_CASES:
        totals, sizes, misaligned = K7_CASES[name]
        for total, wide, bs in ((t, w, b) for t in totals
                                for w in (False, True) for b in sizes):
            n = total - 1
            bs = max(n, 1) if bs == "n" else bs
            nb = -(-max(n, 1) // bs)
            d = _t(rng.integers(0, 2**32, size=2 * n + 3, dtype=np.uint32),
                   dev)
            md = rng.integers(-2**63, 0, size=nb, dtype=np.int64)
            md_u = md.view(np.uint64)
            md_lo = _t((md_u & np.uint64(0xFFFFFFFF)).astype(np.uint32),
                       dev)
            md_hi = _t((md_u >> np.uint64(32)).astype(np.uint32), dev)
            dlo, dhi = ((d[1 : n + 1], d[n + 3 :]) if misaligned
                        else (d[:n], d[n : 2 * n]))
            dhi = dhi if wide else None
            mhi = md_hi if wide else None
            first = int(rng.integers(-2**63, 2**63 - 1))
            got = delta_scan(dlo, dhi, md_lo, mhi, bs, first, total)
            want = delta_scan_plain(
                dlo.cpu(), None if dhi is None else dhi.cpu(),
                md_lo.cpu(), None if mhi is None else mhi.cpu(), bs,
                first, total)
            _same(f"K7 {name}: total {total} wide {wide} block {bs}", got,
                  want)


def hand_snappy(ops):
    """A snappy block written op by op — ``bytes`` for a literal, an
    ``(offset, length)`` pair for a copy with a 4-byte offset (tag 3,
    length 1 to 64, offset at most the bytes so far) — and the bytes it
    decodes to."""
    from tpuparquet_torch.varint import write_uvarint

    body, out = bytearray(), bytearray()
    for op in ops:
        if isinstance(op, (bytes, bytearray)):
            n = len(op) - 1
            if n < 60:
                body.append(n << 2)
            else:
                nb = (n.bit_length() + 7) // 8
                body.append((59 + nb) << 2)
                body += n.to_bytes(nb, "little")
            body += op
            out += op
        else:
            off, ln = op
            assert 0 < off <= len(out) and 1 <= ln <= 64
            body.append(((ln - 1) << 2) | 3)
            body += off.to_bytes(4, "little")
            for _ in range(ln):
                out.append(out[-off])
    head = bytearray()
    write_uvarint(head, len(out))
    return bytes(head + body), np.frombuffer(bytes(out), np.uint8)


def token_blocks(rng) -> dict:
    """Snappy blocks whose copy graphs pin K8's edges, each as (block,
    bytes): long chains, copies across its 16 KiB tiles, copies from more
    than 64 KiB back (4-byte offsets, hand-made), literal tokens longer
    than a tile, and a length of 3 mod 4."""
    from tpuparquet_torch.compress import compress_block
    from tpuparquet_torch.format.metadata import CompressionCodec

    def lit(n):
        return rng.integers(0, 256, size=n, dtype=np.uint8).tobytes()

    far = [lit(70_000)]
    size = 70_000
    for k in range(1500):
        off = (70_000, 65_537, 98_304)[k % 3]
        if off > size:
            off = 70_000
        far.append((off, 64))
        size += 64
    far += [lit(999), (1, 64), (131_072, 33)]
    blocks = {
        "random": rng.integers(0, 256, size=100_003, dtype=np.uint8),
        "runs at offset 1": np.concatenate([
            np.full(70_000, 7, np.uint8),
            rng.integers(0, 256, size=999, dtype=np.uint8),
            np.full(5_001, 200, np.uint8)]),
        "repeated blocks": np.repeat(
            rng.integers(-2**62, 2**62, size=(800, 64)), 4,
            axis=0).reshape(-1).view(np.uint8),
        # one chain through 19 tiles
        "run over the tiles": np.concatenate([
            rng.integers(0, 256, size=5, dtype=np.uint8),
            np.full(300_001, 9, np.uint8)]),
        # a 3001-byte period: copies cross every tile edge
        "copies across tiles": np.tile(
            rng.integers(0, 256, size=3001, dtype=np.uint8), 40),
        "length 3 mod 4": np.tile(
            rng.integers(0, 256, size=777, dtype=np.uint8), 91)[:70_003],
    }
    out = {k: (compress_block(CompressionCodec.SNAPPY, v), v)
           for k, v in blocks.items()}
    out["copies past 64 KiB"] = hand_snappy(far)
    out["literals over a tile"] = hand_snappy(
        [lit(40_000)] + [(40_000, 64)] * 200 + [lit(50_000), (7, 60)])
    return out


def _check_tokens(rng, dev, names=None) -> None:
    from tpuparquet_torch.kernels.snappy import expand_tokens, \
        expand_tokens_plain, expand_tokens_words, \
        expand_tokens_words_plain, plan_tokens

    blocks = token_blocks(rng)
    for name in names or blocks:
        comp, data = blocks[name]
        te, ts, lp, out_cap, steps, out_len = plan_tokens(comp, data.size)
        dte, dts, dlp = _t(te, dev), _t(ts, dev), _t(lp, dev)
        cte, cts, clp = dte.cpu(), dts.cpu(), dlp.cpu()
        blob = expand_tokens(dte, dts, dlp, out_cap, steps)
        _same(f"K8 {name} blob", blob,
              expand_tokens_plain(cte, cts, clp, out_cap, steps))
        if not np.array_equal(blob[:out_len].cpu().numpy(), data):
            raise AssertionError(f"K8 {name}: wrong bytes")
        for off in (0, 1, 3):
            nw = (out_len - off) // 4
            words = expand_tokens_words(dte, dts, dlp, out_cap, steps, off,
                                        nw)
            _same(f"K8 {name} words at {off}", words,
                  expand_tokens_words_plain(cte, cts, clp, out_cap, steps,
                                            off, nw))
            want = data[off : off + 4 * nw].view("<u4")
            if not np.array_equal(words.cpu().numpy().view(np.uint32),
                                  want):
                raise AssertionError(f"K8 {name} at {off}: wrong words")


def _staged_dictionary(rng, n_entries: int, max_len: int, min_len: int = 0,
                       empty=None):
    """A BYTE_ARRAY dictionary as the planner stages it: int32 offsets and
    u8 data, each zero-padded to the JAX piece split's length (entry
    ``empty``, if given, is the empty string).  Returns (offsets, data,
    lengths)."""
    from tpuparquet_torch.kernels.device import _padded_len

    lens = rng.integers(min_len, max_len, size=n_entries, endpoint=True)
    if empty is not None:
        lens[empty] = 0
    offs = np.zeros(_padded_len(n_entries + 1), dtype=np.int32)
    offs[1 : n_entries + 1] = np.cumsum(lens)
    data = np.zeros(_padded_len(int(lens.sum()), 1), dtype=np.uint8)
    data[: int(lens.sum())] = rng.integers(0, 256, size=int(lens.sum()),
                                           dtype=np.uint8)
    return offs, data, lens


# K9's cases: (entries, max length, values, width, stream, options).
# Options: "min_len" (every entry at least this long), "empty_run" (slots
# a:b take entry 0, the empty string), "past" (every 7th index past the
# dictionary's entries: onto its zero padding, or clamped), "tail" (the
# index stream fills every slot of the bucket and the last one picks the
# dictionary's last entry, which the bytes past the values' end read)
DICT_BYTES_CASES = {
    "single run": (200, 12, 20_000, 8, "single", {}),
    "run table": (200, 12, 20_000, 8, "table", {}),
    "width 0": (1, 9, 1000, 0, None, {}),
    "empty blob": (5, 0, 3000, 3, "table", {}),
    "exact bucket": (37, 30, 1024, 6, "single", {}),
    "all null": (37, 30, 0, 6, "table", {}),
    # 20,000 entries of up to 4,000 bytes: the staged data spans several
    # 16 MB pieces
    "16 MB pieces": (20_000, 4000, 3000, 15, "table", {}),
    "value over a tile": (3, 90_000, 40, 2, "single",
                          {"min_len": 70_000}),
    "5000 empty values": (50, 20, 12_000, 6, "table",
                          {"empty_run": (3000, 8000)}),
    "tail reads the last entry": (37, 30, 3000, 6, "single",
                                  {"tail": True}),
    "indices past the dictionary": (37, 30, 3000, 7, "table",
                                    {"past": True}),
}


def dict_bytes_case(rng, case):
    """Staged dictionary and index slots of one of DICT_BYTES_CASES:
    (offsets, data, values, index width, stream kind, slot indices)."""
    n_ent, max_len, nn, w, how, opt = DICT_BYTES_CASES[case]
    empty = 0 if "empty_run" in opt else None
    offs, data, _ = _staged_dictionary(rng, n_ent, max_len,
                                       opt.get("min_len", 0), empty)
    idx = rng.integers(0, n_ent, size=nn).astype(np.uint32)
    if nn:
        idx[nn // 3 : nn // 3 + 50] = idx[0]  # a run
    if "empty_run" in opt:
        a, b = opt["empty_run"]
        idx[a:b] = 0
    if opt.get("past"):
        idx[::7] = rng.integers(n_ent + 1, 1 << w, size=idx[::7].size)
    if opt.get("tail"):
        from tpuparquet_torch.kernels.decode import bucket

        full = np.zeros(bucket(nn), np.uint32)
        full[:nn] = idx
        full[-1] = n_ent - 1
        idx = full
    if w == 0:
        idx[:] = 0
    return offs, data, nn, w, how, idx


def _check_dict_bytes(rng, dev, cases=None) -> None:
    """K9 against its plain version over the whole padded output, and its
    values against a host gather."""
    from tpuparquet_torch.kernels.decode import bucket, page_dict_bytes, \
        page_dict_bytes_plain

    for label in cases or DICT_BYTES_CASES:
        offs, data, nn, w, how, idx = dict_bytes_case(rng, label)
        if w == 0:
            bp = tbl = None
            cnt, nbp, single = bucket(max(nn, 1)), 0, False
        else:
            bp, tbl, cnt, nbp = _stream(idx, w, dev)
            single = how == "single"
            if single:
                bp = _one_run(idx, w, cnt, dev)
        # the staged lengths, at the indices as the kernel clamps them
        slens = np.diff(offs)
        k = np.minimum(idx[:nn].astype(np.int64), slens.size - 1)
        total_b = int(slens[k].sum())
        cap = bucket(max(total_b, 1))
        doffs, ddata = _t(offs, dev), _t(data, dev)
        got = page_dict_bytes(doffs, ddata, bp, tbl, nn, cnt, w, nbp, cap,
                              single)
        cpu = [None if t is None else t.cpu() for t in (bp, tbl)]
        _same(f"K9 {label}", got, page_dict_bytes_plain(
            doffs.cpu(), ddata.cpu(), *cpu, nn, cnt, w, nbp, cap, single))
        want = np.concatenate([data[a : a + n] for a, n in
                               zip(offs[k].astype(np.int64), slens[k])]
                              or [np.zeros(0, np.uint8)])
        if not np.array_equal(got[:total_b].cpu().numpy(), want):
            raise AssertionError(f"K9 {label}: wrong bytes")


# K10's cases: (values, max length, pos, bytes cut off the blob, layout).
# csrc/bytes_from_blob.cu takes tiles of decode.blob_tile_bytes() output
# bytes and stages up to a quarter as many value ends a tile.  Layouts
# (blob_lens): "long", one value over two tiles; "empty run", tile / 4 +
# 100 empty values inside the first tile, whose ends are then searched in
# device memory; "empty at edge", 300 empty values whose ends lie on the
# first tile edge; "nb -1" and "nb +1", the values' bytes one short of and
# one past a tile (the values count then follows from the lengths).  1,023 values leave the offsets unpadded
# (1,024 entries): the tail runs on from the last value's bytes.  A cut
# blob makes the tail reach past its end
BLOB_CASES = {
    "pos 0": (5000, 40, 0, 0, None),
    "odd pos": (5000, 40, 7, 0, None),
    "empty values": (300, 0, 3, 0, None),
    "short blob": (5000, 40, 5, 999, None),
    "pos 1": (5000, 40, 1, 0, None),
    "pos 2": (5000, 40, 2, 0, None),
    "pos 3": (5000, 40, 3, 0, None),
    "value over two tiles": (500, 40, 2, 0, "long"),
    "empty run in a tile": (3000, 40, 1, 0, "empty run"),
    "empty run at a tile edge": (3000, 40, 3, 0, "empty at edge"),
    "nb one short of a tile": (0, 40, 3, 0, "nb -1"),
    "nb one past a tile": (0, 40, 1, 0, "nb +1"),
    "unpadded tail": (1023, 40, 2, 0, None),
    "short unpadded tail": (1023, 40, 2, 999, None),
}


def blob_lens(rng, n: int, max_len: int, layout=None) -> np.ndarray:
    """The value lengths of a K10 case (see BLOB_CASES)."""
    from tpuparquet_torch.kernels.decode import blob_tile_bytes

    tile = blob_tile_bytes()
    if layout in ("nb -1", "nb +1"):
        nb = tile - 1 if layout == "nb -1" else tile + 1
        lens = rng.integers(1, max_len, size=nb, endpoint=True)
        cs = np.cumsum(lens)
        i = int(np.searchsorted(cs, nb))
        lens = lens[: i + 1]
        lens[-1] -= cs[i] - nb
        return lens
    empty = layout in ("empty run", "empty at edge")
    lens = rng.integers(1 if empty else 0, max_len, size=n, endpoint=True)
    if layout == "long":
        lens[n // 2] = 2 * tile + 77
    elif empty:
        cs = np.cumsum(lens)
        i = int(np.searchsorted(cs, tile))  # cs[i - 1] < tile <= cs[i]
        if layout == "empty at edge":
            lens[i] -= cs[i] - tile  # value i ends on the tile edge
            at, run = i + 1, 300
        else:  # after value i - 1, which ends inside the first tile
            at, run = i, tile // 4 + 100
        lens = np.concatenate([lens[:at], np.zeros(run, lens.dtype),
                               lens[at:]])
    return lens


def blob_case(rng, n, max_len, pos, cut, layout=None):
    """A K10 input: ``(blob, padded offsets, pos, cap, value bytes)``, the
    blob a bucket wide as K8 leaves it (``cut`` bytes shorter)."""
    from tpuparquet_torch.kernels.decode import bucket

    lens = blob_lens(rng, n, max_len, layout)
    n = lens.size
    offs = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(lens, out=offs[1:])
    nb = int(offs[-1])
    vals = rng.integers(0, 256, size=nb, dtype=np.uint8)
    # records (u32 length, bytes) behind pos level bytes
    heads = ((pos + offs[:-1] + 4 * np.arange(n))[:, None]
             + np.arange(4)).reshape(-1)
    page = np.empty(pos + 4 * n + nb, np.uint8)
    page[:pos] = rng.integers(0, 256, size=pos, dtype=np.uint8)
    page[heads] = lens.astype("<u4").view(np.uint8)
    body = np.ones(page.size, bool)
    body[:pos] = False
    body[heads] = False
    page[body] = vals
    wide = np.zeros(bucket(page.size), np.uint8)
    wide[: page.size] = page
    wide = wide[: wide.size - cut] if cut else wide
    offs_pad = np.full(bucket(n + 1), nb, dtype=np.int32)
    offs_pad[: n + 1] = offs
    return wide, offs_pad, pos, bucket(max(nb, 1)), vals


def _check_bytes_from_blob(rng, dev, names=None) -> None:
    """K10 against its plain version over the whole padded output, and
    its values against the records it reads, on BLOB_CASES."""
    from tpuparquet_torch.kernels.decode import plain_bytes_from_blob, \
        plain_bytes_from_blob_plain

    for label in names or BLOB_CASES:
        wide, offs_pad, pos, cap, vals = blob_case(rng, *BLOB_CASES[label])
        b_d, o_d = _t(wide, dev), _t(offs_pad, dev)
        got = plain_bytes_from_blob(b_d, o_d, pos, cap)
        _same(f"K10 {label}", got,
              plain_bytes_from_blob_plain(b_d.cpu(), o_d.cpu(), pos, cap))
        if not np.array_equal(got[: vals.size].cpu().numpy(), vals):
            raise AssertionError(f"K10 {label}: wrong bytes")


def _bursty(rng, n: int) -> np.ndarray:
    """Microsecond timestamps with lognormal gaps (the sensor table's):
    miniblock widths vary, so width classes scatter."""
    return 1_700_000_000_000_000 + np.cumsum(
        rng.lognormal(8.0, 2.5, n).astype(np.int64))


def _device_plan(plan, dev):
    """A host DeltaPlan with its arrays on ``dev``."""
    from tpuparquet_torch.kernels.decode import DeltaPlan

    return DeltaPlan(
        [(w, _t(words, dev), None if st is None else _t(st, dev),
          None if tk is None else _t(tk, dev), nv, s0, nt)
         for w, words, st, tk, nv, s0, nt in plan.groups],
        _t(plan.md_lo, dev), _t(plan.md_hi, dev), plan.block_size,
        plan.first, plan.total)


def _check_delta_scatter(rng, dev) -> None:
    """K11 against its plain version over the whole delta stream: int32
    and int64 lanes, miniblocks of 32 and 64 in shuffled order, a partial
    last miniblock, one miniblock past ``out_len`` and one straddling it;
    then whole DELTA_BINARY_PACKED streams of bursty timestamps (block
    256 with 4 and 8 miniblocks) rebuilt on the card."""
    from tpuparquet_torch.cpu.delta import encode_delta_binary_packed
    from tpuparquet_torch.kernels.decode import expand_delta_i32, \
        expand_delta_i64, plan_delta_i32, plan_delta_i64, scatter_deltas, \
        scatter_deltas_plain

    for wide in (False, True):
        for mb, k in ((32, 37), (64, 1000), (32, 40_000)):
            out_len = k * mb - 17
            order = rng.permutation(k)
            starts = (order * mb).astype(np.int32)
            takes = np.full(k, mb, np.int32)
            takes[int(np.argmax(order))] = mb - 9   # the partial last one
            starts[int(np.argmin(order))] = out_len + 5  # past out_len
            lo, hi = (_t(rng.integers(0, 2**32, size=k * mb,
                                      dtype=np.uint32), dev)
                      for _ in range(2))
            st, tk = _t(starts, dev), _t(takes, dev)
            dlo = torch.zeros(out_len, dtype=torch.int32, device=dev)
            dhi = torch.zeros_like(dlo) if wide else None
            scatter_deltas(lo, hi if wide else None, st, tk, k * mb, dlo,
                           dhi, out_len)
            plo = torch.zeros(out_len, dtype=torch.int32)
            phi = torch.zeros_like(plo) if wide else None
            scatter_deltas_plain(lo.cpu(), hi.cpu() if wide else None,
                                 st.cpu(), tk.cpu(), k * mb, plo, phi,
                                 out_len)
            _same(f"K11 mb {mb} k {k} wide {wide} lo", dlo, plo)
            if wide:
                _same(f"K11 mb {mb} k {k} hi", dhi, phi)
    for block, n_mb in ((256, 4), (256, 8)):
        ts = _bursty(rng, 100_003)
        for i32 in (False, True):
            v = (ts % 2**31).astype(np.int32) if i32 else ts
            plan = (plan_delta_i32 if i32 else plan_delta_i64)(
                encode_delta_binary_packed(v, block, n_mb))
            if not any(g[2] is not None for g in plan.groups):
                raise AssertionError("K11 check: no scattered width class")
            got = (expand_delta_i32 if i32 else expand_delta_i64)(
                _device_plan(plan, dev))
            if not np.array_equal(got.cpu().numpy().view(v.dtype), v):
                raise AssertionError(f"K11 block {block}/{n_mb} int32 {i32}: "
                                     "wrong values")


def _check_bss(rng, dev) -> None:
    """K12 against its plain version: 4 and 8 streams (and 6, a partial
    last lane), counts not a multiple of 32."""
    from tpuparquet_torch.kernels.decode import bss_to_lanes, \
        bss_to_lanes_plain

    for k, lanes in ((4, 1), (8, 2), (6, 2)):
        for count in (1, 1000, 1_000_003):
            raw = _t(rng.integers(0, 256, size=k * count + 3,
                                  dtype=np.uint8), dev)
            _same(f"K12 k {k} count {count}",
                  bss_to_lanes(raw, count, k, lanes),
                  bss_to_lanes_plain(raw.cpu(), count, k, lanes))


# K12 where its design has edges (T = decode.bss_lanes_tile_rows(lanes),
# lanes = ceil(k / 4)): name -> (stream counts k, row counts as a function
# of T, bytes the streams start into their buffer, spare bytes past k *
# count).  k 1-16 takes every partial last lane of 1-4 lanes; counts at
# every residue mod 16 start the streams (s * count) at every alignment,
# and views 1, 3, 5, 8 and 13 bytes in shift them all; k 1,024 fills a
# block's shared memory with 256 lanes' streams at T = 16, and k 1,025,
# 1,031 and 2,053 split their lanes over gridDim.y (2, 2 and 3 groups).
_BSS_K = tuple(range(1, 17))
_BSS_WIDE = (1, 15, 16, 17, 87, 1000)
BSS_EDGE_CASES = {
    **{f"count {n}": (_BSS_K, lambda t, n=n: (n,), 0, 3)
       for n in (1, 15, 16, 17)},
    "tile - 1": (_BSS_K, lambda t: (t - 1,), 0, 3),
    "tile": (_BSS_K, lambda t: (t,), 0, 3),
    "tile + 1": (_BSS_K, lambda t: (t + 1,), 0, 3),
    "5 tiles + 7": ((4, 8), lambda t: (5 * t + 7,), 0, 3),
    **{f"count 16m + {r}": ((8,), lambda t, r=r: (3 * t + r,), 0, 3)
       for r in range(1, 16)},
    **{f"view {v} bytes in": ((4, 6, 8, 16), lambda t: (1, 5 * t + 7), v, 3)
       for v in (1, 3, 5, 8, 13)},
    "exactly k * count bytes": ((1, 4, 7, 8, 13, 16),
                                lambda t: (1, 17, t + 1, 5 * t + 7), 0, 0),
    **{f"k {k:,}": ((k,), lambda t: _BSS_WIDE, 0, 3)
       for k in (1024, 1025, 1031)},
    "k 2,053 from a view 13 bytes in": ((2053,), lambda t: _BSS_WIDE, 13, 0),
}


def bss_case(rng, name: str) -> list:
    """A K12 edge case (see BSS_EDGE_CASES): ``[(buf, lead, count, k,
    lanes)]``, the streams being ``buf[lead:]`` (uint8, ``k * count`` bytes
    and the case's spare ones)."""
    from tpuparquet_torch.kernels.decode import bss_lanes_tile_rows

    ks, counts_fn, lead, spare = BSS_EDGE_CASES[name]
    out = []
    for k in ks:
        lanes = -(-k // 4)
        for count in counts_fn(bss_lanes_tile_rows(lanes)):
            buf = rng.integers(0, 256, size=lead + k * count + spare,
                               dtype=np.uint8)
            out.append((buf, lead, count, k, lanes))
    return out


def _check_bss_edges(rng, dev, names=None) -> None:
    """K12 against its plain version over the whole output on
    BSS_EDGE_CASES, each output allocated over garbage."""
    from tpuparquet_torch.kernels.decode import bss_to_lanes, \
        bss_to_lanes_plain

    for name in names or BSS_EDGE_CASES:
        for buf, lead, count, k, lanes in bss_case(rng, name):
            raw = _t(buf, dev)[lead:]
            _dirty(dev, 4 * count * lanes)
            _same(f"K12 {name} k {k} count {count}",
                  bss_to_lanes(raw, count, k, lanes),
                  bss_to_lanes_plain(raw.cpu(), count, k, lanes))


def _check_flba(rng, dev) -> None:
    """K13 against its plain version and the host's row padding: row
    lengths 1-24 that fill whole lanes (copied) and that leave a partial
    last lane (tiled), and 1,031 (wider than a tile holds); counts one
    short of, at and one past a tile, five tiles and an odd remainder;
    rows read from views 1, 3, 5, 8 and 13 bytes into their buffer (each
    of the copy's four word shifts, with and without a byte shift)."""
    from tpuparquet_torch.kernels.decode import flba_bytes_to_lanes, \
        flba_bytes_to_lanes_plain, flba_tile_rows
    from tpuparquet_torch.kernels.device import _stage_byte_rows_np

    for length in (1, 3, 4, 5, 7, 8, 9, 12, 13, 16, 17, 20, 22, 24, 1031):
        R = flba_tile_rows(length)
        counts = (1, 17, 1000) if length > 1024 else \
            (1, 1000, 100_003, R - 1, R, R + 1, 5 * R + 7)
        for count in counts:
            raw = rng.integers(0, 256, size=count * length + 13,
                               dtype=np.uint8)
            raw_d = _t(raw, dev)
            for off in (0, 1, 3, 5, 8, 13) \
                    if count in (R + 1, 5 * R + 7) \
                    else (0,):
                name = f"K13 L {length} count {count} offset {off}"
                got = flba_bytes_to_lanes(raw_d[off:], count, length)
                _same(name, got, flba_bytes_to_lanes_plain(
                    _t(raw[off:], "cpu"), count, length))
                want = _stage_byte_rows_np(
                    raw[off : off + count * length].reshape(count, length))
                if not np.array_equal(got.cpu().numpy().view(np.uint32),
                                      want):
                    raise AssertionError(f"{name}: wrong words")


def _check_new_shapes(rng, dev) -> None:
    """K3 at 3 and 4 lanes (INT96 and FIXED_LEN_BYTE_ARRAY(16)
    dictionaries, staged padded to a length that is no multiple of the
    lanes), K12 with k != 4 * lanes, and K8 on the copy graph of
    front-coded strings (zero-length prefix tokens included), then K13
    on front-coded rows."""
    from tpuparquet_torch.cpu.delta import encode_delta_byte_array
    from tpuparquet_torch.cpu.plain import ByteArrayColumn
    from tpuparquet_torch.kernels.decode import bss_to_lanes, \
        bss_to_lanes_plain, bucket, page_dict_fixed, page_dict_fixed_plain
    from tpuparquet_torch.kernels.device import _plan_dba_page, _put_all, \
        _Stager
    from tpuparquet_torch.kernels.snappy import expand_tokens, \
        expand_tokens_plain

    for lanes in (3, 4):
        # 30 values staged as the planner stages them: bucket(30 * lanes)
        d = _t(rng.integers(0, 2**32, size=128, dtype=np.uint32), dev)
        for w, single in ((5, False), (5, True), (6, False)):
            idx = _runny(rng, 20_000, w)
            bp, tbl, cnt, nbp = _stream(idx, w, dev)
            if single:
                bp = _one_run(idx, w, cnt, dev)
            _same(f"K3 lanes {lanes} width {w} single {single}",
                  page_dict_fixed(d, bp, tbl, cnt, w, nbp, lanes, single),
                  page_dict_fixed_plain(d, bp, tbl, cnt, w, nbp, lanes,
                                        single))
    for k, lanes in ((9, 3), (16, 4)):
        for count in (1, 1000, 1_000_003):
            raw = _t(rng.integers(0, 256, size=k * count + 3,
                                  dtype=np.uint8), dev)
            _same(f"K12 k {k} lanes {lanes} count {count}",
                  bss_to_lanes(raw, count, k, lanes),
                  bss_to_lanes_plain(raw.cpu(), count, k, lanes))
    groups = mr_v2_groups(30_000, 1)[0][0]
    for name, flba in (("url", None), ("amount", 16)):
        if flba is None:
            col = ByteArrayColumn(*groups[name])
            # a run of values sharing no prefix: zero-length copy tokens
            col = ByteArrayColumn(
                np.concatenate([col.offsets, col.offsets[-1]
                                + np.arange(1, 41) * 3]),
                np.concatenate([col.data, rng.integers(
                    0, 256, size=120, dtype=np.uint8)]))
            want = col
        else:
            rows = groups[name]
            col = ByteArrayColumn(np.arange(len(rows) + 1) * flba,
                                  rows.reshape(-1))
        n = len(col)
        seg = np.frombuffer(encode_delta_byte_array(col), np.uint8)
        stg = _Stager()
        op = _plan_dba_page(seg, flba, None, n, n, 0, stg)[0]
        (staged,), _slab = _put_all([stg], dev)
        te, ts, lits = staged
        expanded = int(col.offsets[-1])
        out_cap = bucket(expanded)
        steps = max(int(np.ceil(np.log2(max(expanded, 2)))), 1)
        got = expand_tokens(te, ts, lits, out_cap, steps)
        _same(f"K8 front coding {name}", got, expand_tokens_plain(
            te.cpu(), ts.cpu(), lits.cpu(), out_cap, steps))
        if not np.array_equal(got[:expanded].cpu().numpy(), col.data):
            raise AssertionError(f"K8 front coding {name}: wrong bytes")
        parts = {"val": [], "bytes": [], "def": [], "device": dev}
        op(staged, parts)
        if flba is None:
            if not np.array_equal(parts["bytes"][0][1][:expanded].cpu()
                                  .numpy(), want.data):
                raise AssertionError("DELTA_BYTE_ARRAY strings: wrong bytes")
        elif not np.array_equal(parts["val"][0][0].cpu().numpy().view(
                np.uint8).reshape(n, 16), rows):
            raise AssertionError("DELTA_BYTE_ARRAY rows: wrong words")


def _check_pack_bits(rng, dev) -> None:
    """KE1 against its plain version: widths 1, 7, 31, 32, 33, 63 and 64
    at counts 1, 33 and 2^20 + 5, over lanes longer than the count (the
    tail must pack as 0) and over a list of miniblocks, and against the
    host packer."""
    from tpuparquet_torch.cpu.bitpack import pack
    from tpuparquet_torch.kernels.encode import pack_bits, pack_bits_plain

    for w in (1, 7, 31, 32, 33, 63, 64):
        for count in (1, 33, (1 << 20) + 5):
            n_in = count + 40
            v = rng.integers(0, 2**64 - 1, size=n_in, dtype=np.uint64,
                             endpoint=True)
            lo = _t((v & 0xFFFFFFFF).astype(np.uint32), dev)
            hi = _t((v >> 32).astype(np.uint32), dev) if w > 32 else None
            got = pack_bits(lo, hi, w, count)
            _same(f"KE1 width {w} count {count}", got,
                  pack_bits_plain(lo, hi, w, count))
            mask = np.uint64(2**64 - 1 if w == 64 else (1 << w) - 1)
            want = pack(v[:count] & mask, w)
            if _u32(got).astype(np.uint32).tobytes()[: len(want)] != want:
                raise AssertionError(f"KE1 width {w}: wrong words")
            nb = (count + 31) // 32
            sel = _t(rng.permutation(nb).astype(np.int32), dev)
            _same(f"KE1 width {w} count {count} miniblocks",
                  pack_bits(lo, hi, w, count, sel=sel),
                  pack_bits_plain(lo, hi, w, count, sel=sel))


# KE1 where its design has edges (M = encode.pack_warp_miniblocks(), the
# miniblocks a warp takes; a block of 8 warps takes 8 M): name -> (values
# as a function of M, miniblock list, lanes of the inputs less the lanes
# the values span).  Counts 1, 31 and 33 (around a miniblock), one value
# past a warp's, a block's and two blocks' share of miniblocks; a list in
# reverse order, one with repeats, and random miniblocks of a source
# whose last lanes are missing; inputs shorter than the count (lanes past
# them read as 0).  Every case runs at PACK_WIDTHS, from 64-bit values
# whose bits above the width must be masked off.
PACK_WIDTHS = (1, 31, 32, 33, 64)
PACK_EDGE_CASES = {
    **{f"count {n}": (lambda m, n=n: n, None, 0) for n in (1, 31, 33)},
    "warp share + 1": (lambda m: 32 * m + 1, None, 0),
    "block share + 1": (lambda m: 256 * m + 1, None, 0),
    "2 blocks' share + 1": (lambda m: 512 * m + 1, None, 0),
    "miniblocks reversed": (lambda m: 32 * (8 * m + 3), "reverse", 0),
    "miniblocks repeated": (lambda m: 32 * (2 * m + 1) + 5, "repeat", 0),
    "n_in < count": (lambda m: 96 * m + 7, None, -45),
    "n_in < count, miniblocks": (lambda m: 32 * (8 * m + 1) + 17, "random",
                                 -70),
}


def pack_case(rng, name: str) -> list:
    """A KE1 edge case (see PACK_EDGE_CASES): ``[(width, lo, hi, count,
    sel)]``, one a width of PACK_WIDTHS: the inputs' u32 lanes (``hi``
    None up to width 32) and the int32 miniblock list (None without
    one)."""
    from tpuparquet_torch.kernels.encode import pack_warp_miniblocks

    count_fn, layout, short = PACK_EDGE_CASES[name]
    count = count_fn(pack_warp_miniblocks())
    nb = (count + 31) // 32
    sel = None
    if layout == "reverse":
        sel = np.arange(nb, dtype=np.int32)[::-1].copy()
    elif layout == "repeat":
        sel = rng.integers(0, 3, size=nb).astype(np.int32)
        sel[:3] = (2, 2, 0)
    elif layout == "random":
        sel = rng.permutation(nb + 5)[:nb].astype(np.int32)
    n_src = 32 * (nb + 5 if layout == "random" else nb)
    n_in = (n_src if sel is not None else count) + short
    out = []
    for w in PACK_WIDTHS:
        v = rng.integers(0, 2**64 - 1, size=n_in, dtype=np.uint64,
                         endpoint=True)
        lo = (v & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        hi = (v >> np.uint64(32)).astype(np.uint32) if w > 32 else None
        out.append((w, lo, hi, count, sel))
    return out


def _check_pack_edges(rng, dev, names=None) -> None:
    """KE1 against its plain version over the whole output on
    PACK_EDGE_CASES, each output allocated over garbage."""
    from tpuparquet_torch.kernels.encode import pack_bits, pack_bits_plain

    for name in names or PACK_EDGE_CASES:
        for w, lo, hi, count, sel in pack_case(rng, name):
            args = [None if a is None else _t(a, dev) for a in (lo, hi, sel)]
            _dirty(dev, 4 * w * ((count + 31) // 32))
            got = pack_bits(args[0], args[1], w, count, sel=args[2])
            _same(f"KE1 {name} width {w}", got, pack_bits_plain(
                *(None if a is None else a.cpu() for a in args[:2]), w,
                count, sel=None if sel is None else args[2].cpu()))


# KE5 where its design has edges (16-byte vectors of 4 / lanes values; a
# block of 256 threads takes 4 vectors a thread a round): name -> the
# calls, each (values, words the view starts into its buffer, unsigned
# order), made by a function of the rng.  One value; n at a vector's
# values and one past; a block's round of vectors and one past; views 1
# word (1 lane) and 2 words (2 lanes) into their buffer, and 1 word (2
# lanes: no 16-byte vector, every value alone); the extremes in the last
# vector of 9 blocks' rounds, which the last thread of the last block
# reads; NaN in the tail only; all NaN; and calls back to back whose
# grids differ, so a ticket the last block failed to reset shows.
def _nan_tail(rng, dt, n: int, tail: int):
    v = rng.normal(size=n).astype(dt)
    v[n - tail:] = np.nan
    return v


MINMAX_EDGE_CASES = {
    "one value": lambda r: [(np.array([-2.5]), 0, False),
                            (np.array([7], np.int32), 0, False),
                            (np.array([-7], np.int64), 0, True)],
    "vector's values": lambda r: [(r.normal(size=2), 0, False),
                                  (r.integers(-9, 9, 4).astype(np.int32),
                                   0, False),
                                  (r.normal(size=4).astype(np.float32), 0,
                                   False)],
    "vector's values + 1": lambda r: [
        (r.normal(size=3), 0, False),
        (r.integers(-9, 9, 5).astype(np.int32), 0, True),
        (r.integers(-2**62, 2**62, 3), 0, False)],
    "block round ± 1": lambda r: [
        (r.normal(size=2048 + d), 0, False) for d in (-1, 0, 1)] + [
        (r.integers(-2**31, 2**31, 4096 + d).astype(np.int32), 0, False)
        for d in (-1, 1)],
    "view 1 word in, 1 lane": lambda r: [
        (r.integers(-2**31, 2**31, 1003).astype(np.int32), 1, False),
        (r.normal(size=1003).astype(np.float32), 1, False),
        (r.integers(-2**31, 2**31, 1003).astype(np.int32), 3, True)],
    "view 2 words in, 2 lanes": lambda r: [
        (r.normal(size=1001), 2, False),
        (r.integers(-2**63, 2**63 - 1, 1001), 2, True)],
    "view 1 word in, 2 lanes": lambda r: [
        (r.normal(size=5001), 1, False),
        (r.integers(-2**63, 2**63 - 1, 5001), 1, False)],
    "extremes in the last block": lambda r: [
        (np.concatenate([r.uniform(-1, 1, 9 * 2048 - 2), [-5.0, 5.0]]), 0,
         False),
        (np.concatenate([r.integers(-1000, 1000, 9 * 4096 - 2),
                         [-2**31, 2**31 - 1]]).astype(np.int32), 0, False)],
    "NaN in the tail only": lambda r: [(_nan_tail(r, np.float64, 1001, 1),
                                        0, False),
                                       (_nan_tail(r, np.float32, 1003, 3),
                                        0, False)],
    "all NaN": lambda r: [
        (np.full(3000, np.nan), 0, False),
        (np.array([np.nan, -np.nan] * 1501, np.float32), 0, False),
        (np.full(7, np.nan), 2, False)],
    "back to back, other grids": lambda r: [
        (r.normal(size=(1 << 20) + 3), 0, False), (np.array([3.5]), 0, False),
        (r.normal(size=5000), 0, False),
        (r.normal(size=(1 << 20) + 3), 0, False),
        (r.integers(-2**31, 2**31, 2).astype(np.int32), 0, False)],
}


def minmax_case(rng, name: str) -> list:
    """A KE5 edge case (see MINMAX_EDGE_CASES): ``[(buf, lead, values,
    unsigned)]``, the values' u32 words being ``buf[lead:]`` after
    ``lead`` garbage words."""
    out = []
    for v, lead, unsigned in MINMAX_EDGE_CASES[name](rng):
        words = np.ascontiguousarray(v).view(np.uint32)
        buf = np.concatenate([rng.integers(0, 2**32, size=lead,
                                           dtype=np.uint32), words])
        out.append((buf, lead, v, unsigned))
    return out


def _minmax_order(v: np.ndarray, unsigned: bool) -> str:
    return "float" if v.dtype.kind == "f" else \
        "unsigned" if unsigned else "signed"


def _check_minmax_edges(rng, dev, names=None) -> None:
    """KE5 against its plain version on MINMAX_EDGE_CASES, the calls of a
    case back to back, each over garbage: the host buffer the keys land
    in holds random words before every call."""
    from tpuparquet_torch.kernels._lib import stream_of
    from tpuparquet_torch.kernels.encode import _min_max_state, \
        lanes_min_max, lanes_min_max_plain

    for name in names or MINMAX_EDGE_CASES:
        for k, (buf, lead, v, unsigned) in enumerate(minmax_case(rng, name)):
            flat = _t(buf, dev)[lead:]
            lanes, order = v.itemsize // 4, _minmax_order(v, unsigned)
            if dev.type == "cuda":
                st = _min_max_state(dev, stream_of(flat))
                st.keys[:] = rng.integers(0, 2**63, size=2, dtype=np.uint64)
            got = lanes_min_max(flat, lanes, order)
            want = lanes_min_max_plain(flat.cpu(), lanes, order)
            if got != want:
                raise AssertionError(f"KE5 {name} call {k} ({v.dtype}, "
                                     f"{order}, {v.size} values, view "
                                     f"{lead} words in): {got}, plain "
                                     f"{want}")


# KE3's cases: (counts, offset).  A warp of csrc/delta_encode.cu takes 4
# blocks of 128 deltas (512), a CTA 8 warps (4,096 deltas); count - 1
# deltas.  "offset": the values start one word into their buffer, which
# the kernel loads as scalars
KE3_CASES = {
    "sizes": ((1, 2, 129, 1_000_003), False),
    "warp edges": ((512, 513, 514, 1025), False),
    "CTA edges": ((4096, 4097, 4098, 8193), False),
    "odd word offset": ((2, 4097, 100_003), True),
}


def _check_delta_phase1(rng, dev, names=None) -> None:
    """KE3 against its plain version on int32 deltas that wrap and int64
    extremes, and each page against the host encoder (counts 1 and 2
    included)."""
    from tpuparquet_torch.cpu.delta import encode_delta_binary_packed
    from tpuparquet_torch.kernels.encode import delta_encode_device, \
        delta_phase1, delta_phase1_plain

    for name in names or KE3_CASES:
        counts, offset = KE3_CASES[name]
        for dt, count in ((d, c) for d in (np.int32, np.int64)
                          for c in counts):
            info = np.iinfo(dt)
            v = rng.integers(info.min, info.max, size=count, dtype=dt,
                             endpoint=True)
            v[::5] = info.max
            v[1::7] = info.min
            words = v.view(np.uint32)
            flat = (_t(np.concatenate([[7], words, [9]]).astype(np.uint32),
                       dev)[1 : 1 + words.size] if offset else _t(words, dev))
            is32 = dt == np.int32
            label = f"KE3 {name}: {dt.__name__} count {count}"
            if count >= 2:
                got, want = (delta_phase1(flat, count, is32),
                             delta_phase1_plain(flat, count, is32))
                for i, (g, w_) in enumerate(zip(got, want)):
                    _same(f"{label} output {i}", g, w_)
            if delta_encode_device(flat, count, is32) != \
                    encode_delta_binary_packed(v, is32=is32):
                raise AssertionError(f"{label}: page differs from the host "
                                     "encoder")


# KE4's cases: (range, low bound, layout, values; None: 3 * range +
# 100,000).  Ranges around encode.dict_small_range() (R) take its two
# paths: a block's table in shared memory up to R, the flag scan past it.
# Layouts (dict_values): "uniform"; "hot", every value equal but one at
# each end of the range; "edges", first occurrences at index 31 (the last
# lane of a warp) and 8,191 (the last value of the first of the small
# path's blocks, which take 8,192 values each at 16,384 values)
DICT_CASES = {
    "range 1": (1, 0, "uniform", None),
    "range 7": (7, -3, "uniform", None),
    "range 2^16": (1 << 16, -(1 << 20), "uniform", None),
    "hot value": (7, -3, "hot", None),
    "hot value, range 2^16": (1 << 16, 5, "hot", None),
    "range R - 1": (-1, -3, "uniform", None),
    "range R": (0, -3, "uniform", None),
    "range R + 1": (1, -3, "uniform", None),
    "warp and block edges": (64, 0, "edges", 16_384),
    "warp and block edges, range 8192": (8192, 0, "edges", 16_384),
    "range 2^22": (1 << 22, -7, "uniform", (1 << 20) + 3),
}


def dict_values(rng, name: str, dt) -> np.ndarray:
    """The values of a KE4 case (see DICT_CASES); the range's both ends
    occur."""
    from tpuparquet_torch.kernels.encode import dict_small_range

    span, lo, layout, n = DICT_CASES[name]
    if name.startswith("range R"):
        span += dict_small_range()
    n = 3 * span + 100_000 if n is None else n
    if layout == "hot":
        v = np.full(n, lo + span // 2, np.int64)
    elif layout == "edges":
        v = lo + rng.integers(0, span - 2, size=n)
        v[31] = v[rng.integers(32, n, size=50)] = lo + span - 2
        v[8191] = v[rng.integers(8192, n, size=50)] = lo + span - 1
        v[5] = lo
        return v.astype(dt)
    else:
        v = lo + rng.integers(0, span, size=n)
    a, b = rng.choice(n, size=2, replace=False)
    v[a], v[b] = lo + span - 1, lo
    return v.astype(dt)


def _check_dict_build(rng, dev, names=None) -> None:
    """KE4 against its plain version (order, size, indices) on
    DICT_CASES, int32 and int64."""
    from tpuparquet_torch.kernels.encode import dict_build, dict_build_plain

    for name in names or DICT_CASES:
        for dt in (np.int32, np.int64):
            v = dict_values(rng, name, dt)
            lo = int(v.min())
            span = int(v.max()) - lo + 1
            flat = _t(v.view(np.uint32), dev)
            lanes = v.itemsize // 4
            go, gs, gi = dict_build(flat, lanes, v.size, lo & 0xFFFFFFFF,
                                    span)
            wo, ws, wi = dict_build_plain(flat, lanes, v.size,
                                          lo & 0xFFFFFFFF, span)
            if gs != ws:
                raise AssertionError(f"KE4 {name}: {gs} entries, plain {ws}")
            _same(f"KE4 {dt.__name__} {name} order", go, wo)
            _same(f"KE4 {dt.__name__} {name} indices", gi, wi)


def _check_encode(rng, dev) -> None:
    """KE2-KE5 against their plain versions: KE2 at (k, lanes) (4, 1),
    (4, 2), (8, 2), (3, 1), (9, 3) and (16, 4), counts 1-6, one short of
    and one past a tile and past 2^20 (streams that start off a 16-byte
    boundary), words read from one word into their buffer, and (1601,
    401), whose streams split over two blocks; KE3 at every case of
    KE3_CASES; KE4 at every case of DICT_CASES; KE5 on NaN, all NaN,
    infinities, signed zeros and unsigned order."""
    from tpuparquet_torch.kernels.encode import bss_encode_device, \
        bss_encode_plain, bss_tile_rows, lanes_min_max, lanes_min_max_plain

    for k, lanes in ((4, 1), (4, 2), (8, 2), (3, 1), (9, 3), (16, 4)):
        T = bss_tile_rows(lanes)
        for count in (1, 2, 3, 5, 6, 1001, T - 1, T + 1, (1 << 20) + 2,
                      (1 << 20) + 3, (1 << 20) + 6):
            flat = _t(rng.integers(0, 2**32, size=count * lanes + 5,
                                   dtype=np.uint32), dev)
            # a view one word into its buffer: the tiles' loads start
            # off a 16-byte boundary
            for off in (0, 1) if count in (T + 1, (1 << 20) + 2) else (0,):
                _same(f"KE2 k {k} lanes {lanes} count {count} offset {off}",
                      bss_encode_device(flat[off:], count, k, lanes),
                      bss_encode_plain(flat[off:], count, k, lanes))
    # rows of 401 lanes: a tile's 1,601 streams split over two blocks
    for count in (1, 17, 40):
        flat = _t(rng.integers(0, 2**32, size=count * 401, dtype=np.uint32),
                  dev)
        _same(f"KE2 k 1601 lanes 401 count {count}",
              bss_encode_device(flat, count, 1601, 401),
              bss_encode_plain(flat, count, 1601, 401))
    _check_delta_phase1(rng, dev)
    _check_dict_build(rng, dev)
    _check_minmax_edges(rng, dev)
    cases = [
        (np.array([np.nan, 2.5, -1.0, np.nan], np.float32), "float"),
        (np.full(1000, np.nan), "float"),
        (np.array([np.inf, -np.inf, 0.0, np.nan]), "float"),
        (np.array([0.0, -0.0, 0.0]), "float"),
        (np.array([-0.0, 0.0], np.float32), "float"),
        (np.array([np.nan] * 5 + [-0.0], np.float32), "float"),
        (rng.normal(size=(1 << 20) + 7), "float"),
        (np.array([1, -1, 5], np.int64), "unsigned"),
        (np.array([1, -1, 5], np.int32), "unsigned"),
        (rng.integers(-2**63, 2**63 - 1, size=(1 << 20) + 1), "signed"),
        (rng.integers(-2**63, 2**63 - 1, size=(1 << 20) + 1), "unsigned"),
        (rng.integers(-2**31, 2**31, size=999).astype(np.int32), "signed"),
        (np.array([], np.float64), "float"),
    ]
    for v, order in cases:
        lanes = v.itemsize // 4
        flat = _t(v.view(np.uint32), dev) if v.size else \
            torch.zeros(0, dtype=torch.int32, device=dev)
        got, want = (lanes_min_max(flat, lanes, order),
                     lanes_min_max_plain(flat, lanes, order))
        if got != want:
            raise AssertionError(f"KE5 {v.dtype} {order} ({v.size} "
                                 f"values): {got}, plain {want}")


def _validity(mask: np.ndarray) -> np.ndarray:
    """The positions of levels_to_validity: each slot's packed index, 0
    for leading nulls."""
    return np.maximum(np.cumsum(mask.astype(np.int32)) - 1, 0).astype(
        np.int32)


def _index_stream(rng, count: int, width: int) -> bytes:
    """A hybrid index stream of ``count`` values, RLE and bit-packed runs
    mixed; at width 0 one bit-packed group of 8 (no bytes), then an RLE
    run of the rest."""
    from tpuparquet_torch.cpu.hybrid import encode_hybrid

    if width == 0:
        return bytes([3]) + _varint((count - 8) << 1)
    return encode_hybrid(_runny(rng, count, width).astype(np.uint32), width)


def _varint(v: int) -> bytes:
    out = bytearray()
    while v >= 0x80:
        out.append((v & 0x7F) | 0x80)
        v >>= 7
    out.append(v)
    return bytes(out)


def _step_inputs(batch, dictionary, dev):
    """A stacked batch's arrays and a dictionary as the step's tensors on
    ``dev``."""
    from tpuparquet_torch.shard.mesh import _as_i32

    return [_as_i32(a).to(dev) for a in batch.arrays()], \
        _as_i32(dictionary).to(dev)


def hybrid_runs(runs, width: int) -> bytes:
    """A hybrid stream of the given runs, in order: ``(n, v)`` an RLE run
    of n values v, an array a bit-packed run (a multiple of 8 values)."""
    from tpuparquet_torch.cpu.bitpack import pack

    out = bytearray()
    for r in runs:
        if isinstance(r, tuple):
            out += _varint(r[0] << 1) + int(r[1]).to_bytes(
                (width + 7) // 8, "little")
        else:
            out += _varint((r.size // 8) << 1 | 1) + pack(
                r.astype(np.uint64), width)
    return bytes(out)


# KS2 where its tiles have edges (T = gather.spmd_tile_positions()):
# name -> (the stream counts as a function of T, or a layout, width,
# dictionary shape, count), count None for stack_hybrid_plans' bucket.  Counts T - 1,
# T and T + 1; a unit of exactly R = 32 runs whose last is bit-packed, so
# the padded positions clamp into it and past its lanes (the other unit
# is one RLE run, so R stays 32); an RLE run over a tile edge; a count of
# 3,003 whose shares on sp 3 start off 16-byte boundaries at 1 and 3
# lanes; a unit of 40 values beside one of 2,000 runs, whose tile meets
# more runs than a block stages.  Lanes 1, 3 and 8; dictionaries shorter
# than 2^width.
STEP_EDGE_CASES = {
    "tile - 1": (lambda t: (t - 1, 77), 5, (20, 1), None),
    "tile": (lambda t: (t, t - 1, 5), 4, (9, 3), None),
    "tile + 1": (lambda t: (t + 1, t, 40), 3, (6, 8), None),
    "bit-packed last run": ("last bp", 4, (12, 3), None),
    "rle over a tile edge": ("rle edge", 6, (50, 8), None),
    "odd count over sp 3": (lambda t: (3003, 1500), 7, (100, 3), 3003),
    "short unit beside 2,000 runs": ("many runs", 1, (2, 8), None),
}


def step_edge_case(rng, name: str):
    """A KS2 edge case: ``(streams, counts, width, dictionary, count)``
    (see STEP_EDGE_CASES)."""
    from tpuparquet_torch.kernels.gather import spmd_tile_positions

    t = spmd_tile_positions()
    layout, width, dshape, count = STEP_EDGE_CASES[name]
    hi = (1 << width) - 1

    def bp(n):
        return rng.integers(0, hi, size=n, endpoint=True, dtype=np.uint32)

    if layout == "last bp":  # 16 x (RLE of 10, 16 bit-packed): 32 runs
        runs = [r for k in range(16) for r in ((10, k % 8), bp(16))]
        streams = [hybrid_runs(runs, width), hybrid_runs([(300, 2)], width)]
        counts = (416, 300)
    elif layout == "many runs":  # 1,000 x (RLE of 8, 8 bit-packed)
        runs = [r for k in range(1000) for r in ((8, k % 2), bp(8))]
        streams = [hybrid_runs(runs, width), hybrid_runs([(40, 1)], width)]
        counts = (16_000, 40)
    elif layout == "rle edge":  # an RLE run over positions t - 48 .. t + 51
        n = 2 * t + 17
        rest = n - (t + 52)
        runs = [bp(t - 48), (100, 5), bp(-(-rest // 8) * 8)]
        streams, counts = [hybrid_runs(runs, width)], (n,)
    else:
        counts = layout(t)
        streams = [_index_stream(rng, c, width) for c in counts]
    dictionary = rng.integers(0, 2**32, size=dshape, dtype=np.uint32)
    return streams, counts, width, dictionary, count


def _check_spmd_edges(rng, dev, names=None) -> None:
    """KS2 against its plain version over the whole output on
    STEP_EDGE_CASES, on every slot of each sp in 1-4 that divides the
    count; garbage in the output first, so every word is written."""
    from tpuparquet_torch.kernels.gather import spmd_step_slot, \
        spmd_step_slot_plain
    from tpuparquet_torch.kernels.hybrid import plan_hybrid
    from tpuparquet_torch.shard.mesh import stack_hybrid_plans

    for name in names or STEP_EDGE_CASES:
        streams, counts, width, d_np, count = step_edge_case(rng, name)
        plans = [plan_hybrid(st, c, width) for st, c in zip(streams, counts)]
        batch = stack_hybrid_plans(plans, count=count)
        arrays, d = _step_inputs(batch, d_np, dev)
        U, cnt, lanes = len(plans), batch.count, d_np.shape[1]
        for sp in (k for k in (1, 2, 3, 4) if cnt % k == 0):
            local = cnt // sp
            got = torch.full((U, cnt, lanes), -1, dtype=torch.int32,
                             device=dev)
            want = got.clone()
            for s_ in range(sp):
                spmd_step_slot(*arrays, d, got, 0, s_ * local, local, width,
                               batch.n_bp)
                spmd_step_slot_plain(*arrays, d, want, 0, s_ * local, local,
                                     width, batch.n_bp)
            _same(f"KS2 {name} sp {sp}", got, want)


# KS3 where its design has edges (T = gather.densify_tile_slots()): name
# -> (slots as a function of T, null share, layout, L - n - 1, B - nb).  Slots T - 1, T, T + 1
# and 8 T + 5 (9 tiles of look-back); leading nulls, all nulls with
# values behind them, all nulls with none (n_packed 0), no slot at all,
# no mask; nb of 15, 16 and 17 bytes; data from a view 3 bytes into its
# buffer; L > n + 1 and B > nb.
DENSIFY_CASES = {
    "tile - 1": (lambda t: t - 1, 0.3, None, 0, 0),
    "tile": (lambda t: t, 0.3, "leading", 0, 0),
    "tile + 1": (lambda t: t + 1, 0.0, "no mask", 0, 0),
    "9 tiles": (lambda t: 8 * t + 5, 0.4, None, 37, 53),
    "leading nulls": (lambda t: 5000, 0.2, "leading", 0, 0),
    "all nulls": (lambda t: 3000, 1.0, None, 0, 0),
    "n_packed 0": (lambda t: 3000, 1.0, "no values", 2, 9),
    "no slots": (lambda t: 0, 0.0, "no mask", 5, 7),
    "nb 15": (lambda t: 20, 0.1, "nb 15", 0, 0),
    "nb 16": (lambda t: 20, 0.1, "nb 16", 0, 0),
    "nb 17": (lambda t: 20, 0.1, "nb 17", 3, 1),
    "data 3 bytes in": (lambda t: t + 100, 0.0, "lead 3", 0, 5),
    "L > n + 1, B > nb": (lambda t: 2000, 0.25, None, 1000, 999),
}


def densify_case(rng, name: str) -> dict:
    """A KS3 edge case (see DENSIFY_CASES) as numpy arrays: ``offsets``
    (n_packed + 1 int32), ``n_packed``, ``mask`` and ``positions`` (None
    for no mask), ``buf`` and ``lead`` (the data is ``buf[lead:]``),
    ``L`` and ``B``."""
    from tpuparquet_torch.kernels.gather import densify_tile_slots

    n_fn, nulls, layout, l_pad, b_pad = DENSIFY_CASES[name]
    n = n_fn(densify_tile_slots())
    mask = rng.random(n) >= nulls
    if layout == "leading":
        mask[:100] = False
    n_packed = 0 if layout == "no values" else (
        500 if nulls == 1.0 else int(mask.sum()))
    lens = rng.integers(0, 12, size=n_packed)
    lens[rng.random(n_packed) < 0.2] = 0  # empty strings
    if layout in ("nb 15", "nb 16", "nb 17"):
        lens = np.zeros(n_packed, np.int64)
        np.add.at(lens, rng.integers(0, n_packed, size=int(layout[3:])), 1)
    offs = np.zeros(n_packed + 1, np.int32)
    np.cumsum(lens, out=offs[1:])
    nb = int(offs[-1])
    lead = 3 if layout == "lead 3" else 0
    buf = rng.integers(0, 256, size=lead + nb, dtype=np.uint8)
    plain = layout in ("no mask", "lead 3")
    return {"offsets": offs, "n_packed": n_packed,
            "mask": None if plain else mask,
            "positions": None if plain else _validity(mask),
            "buf": buf, "lead": lead, "L": n + 1 + l_pad, "B": nb + b_pad}


def _check_densify_edges(rng, dev, names=None) -> None:
    """KS3 against its plain version on DENSIFY_CASES: into fresh rows,
    and into rows 1 and 2 of a 3-row block whose rows are L + 1 words and
    B + 3 bytes (rows that start off 16-byte boundaries, a B not a
    multiple of 16); garbage in every row first."""
    from tpuparquet_torch.kernels.gather import byte_densify, \
        byte_densify_plain

    for name in names or DENSIFY_CASES:
        c = densify_case(rng, name)
        offs = _t(c["offsets"], dev)
        m = None if c["mask"] is None else _t(c["mask"], dev).view(
            torch.bool)
        p = None if c["positions"] is None else _t(c["positions"], dev)
        data = _t(c["buf"], dev)[c["lead"]:]
        L, B = c["L"], c["B"]
        outs = []
        for fn in (byte_densify, byte_densify_plain):
            o = torch.full((L,), -1, dtype=torch.int32, device=dev)
            b = torch.full((B,), 7, dtype=torch.uint8, device=dev)
            fn(offs, c["n_packed"], m, p, data, o, b)
            ob = torch.full((3, L + 1), -1, dtype=torch.int32, device=dev)
            bb = torch.full((3, B + 3), 7, dtype=torch.uint8, device=dev)
            for row in (1, 2):
                fn(offs, c["n_packed"], m, p, data, ob[row], bb[row])
            outs.append((o, b, ob, bb))
        for k, part in enumerate(("offsets", "data", "offsets block",
                                  "data block")):
            _same(f"KS3 {name} {part}", outs[0][k], outs[1][k])


def _check_shard_kernels(rng, dev) -> None:
    """KS1-KS4 against their plain versions on the card."""
    from tpuparquet_torch.kernels.decode import scatter_to_dense, \
        scatter_to_dense_plain
    from tpuparquet_torch.kernels.gather import byte_densify, \
        byte_densify_plain, place_rows, place_rows_plain, spmd_step_slot, \
        spmd_step_slot_plain
    from tpuparquet_torch.kernels.hybrid import plan_hybrid
    from tpuparquet_torch.shard.mesh import stack_hybrid_plans

    n = 100_003
    for lanes in (1, 2, 3, 4):
        for kind, mask in (("some-null", rng.random(n) < 0.8),
                           ("all-null", np.zeros(n, bool)),
                           ("no-null", np.ones(n, bool))):
            packed = _t(rng.integers(0, 2**32, size=int(mask.sum()) * lanes,
                                     dtype=np.uint32), dev)
            m, p = _t(mask, dev).view(torch.bool), _t(_validity(mask), dev)
            want = scatter_to_dense_plain(packed, m, p, lanes)
            _same(f"KS1 lanes {lanes} {kind}",
                  scatter_to_dense(packed, m, p, lanes), want)
            row = torch.full((n * lanes + 77,), -1, dtype=torch.int32,
                             device=dev)
            scatter_to_dense(packed, m, p, lanes, out=row)
            _same(f"KS1 lanes {lanes} {kind} into a row", row,
                  torch.cat([want, torch.zeros(77, dtype=torch.int32,
                                               device=dev)]))
            if kind == "no-null":
                _same(f"KS1 lanes {lanes} without a mask",
                      scatter_to_dense(packed, None, None, lanes), want)
    # KS2: one batch a width, every slot of sp 1, 2 and 4, indices past
    # the dictionary's end (D below 2^width)
    for width in (0, 1, 7, 32):
        counts = (50_000, 777, 4096, 33)
        streams = [_index_stream(rng, c, width) for c in counts]
        plans = [plan_hybrid(st, c, width) for st, c in zip(streams, counts)]
        batch = stack_hybrid_plans(plans, n_units=4)
        for lanes in (1, 3):
            d_np = rng.integers(0, 2**32, size=(max((1 << min(width, 12)) - 3,
                                                    2), lanes),
                                dtype=np.uint32)
            arrays, d = _step_inputs(batch, d_np, dev)
            for sp in (1, 2, 4):
                local = batch.count // sp
                got = torch.full((4, batch.count, lanes), -1,
                                 dtype=torch.int32, device=dev)
                want = got.clone()
                for r in range(2):
                    blk = [a[2 * r : 2 * r + 2].contiguous() for a in arrays]
                    for s_ in range(sp):
                        spmd_step_slot(*blk, d, got, 2 * r, s_ * local,
                                       local, width, batch.n_bp)
                        spmd_step_slot_plain(*blk, d, want, 2 * r,
                                             s_ * local, local, width,
                                             batch.n_bp)
                _same(f"KS2 width {width} lanes {lanes} sp {sp}", got, want)
    # KS3: leading nulls, empty strings, no mask
    for kind in ("nulls", "no-mask"):
        n_packed = 70_001
        lens = rng.integers(0, 12, size=n_packed)
        lens[rng.random(n_packed) < 0.2] = 0  # empty strings
        offs = np.zeros(n_packed + 1, np.int32)
        np.cumsum(lens, out=offs[1:])
        data = _t(rng.integers(0, 256, size=max(int(offs[-1]), 1),
                               dtype=np.uint8)[: int(offs[-1])], dev)
        if kind == "nulls":
            mask = np.ones(n_packed + 9_000, bool)
            mask[:17] = False  # leading nulls
            mask[17 + rng.choice(n_packed + 8_983, 8_983, replace=False)] \
                = False
            m, p = _t(mask, dev).view(torch.bool), _t(_validity(mask), dev)
        else:
            mask, m, p = np.ones(n_packed, bool), None, None
        L, B = mask.size + 1 + 50, int(offs[-1]) + 99
        outs = []
        for fn in (byte_densify, byte_densify_plain):
            o = torch.full((L,), -1, dtype=torch.int32, device=dev)
            b = torch.full((B,), 7, dtype=torch.uint8, device=dev)
            fn(_t(offs, dev), n_packed, m, p, data, o, b)
            outs.append((o, b))
        _same(f"KS3 {kind} offsets", outs[0][0], outs[1][0])
        _same(f"KS3 {kind} data", outs[0][1], outs[1][1])
    _check_spmd_edges(rng, dev)
    _check_densify_edges(rng, dev)
    # KS4: u_out > n_true, word and byte rows
    for shape, dt in (((13, 2001), torch.int32), ((13, 3001), torch.uint8),
                      ((13, 40, 3), torch.int32)):
        x = torch.from_numpy(rng.integers(0, 200, size=shape).astype(
            np.int32)).to(dt).to(dev)
        rows = rng.permutation(13)[:9]
        _same(f"KS4 {tuple(shape)} {dt}", place_rows(x, rows, 9, 16),
              place_rows_plain(x, torch.from_numpy(rows).to(dev), 9, 16))


def check_kernels(dev) -> None:
    """Phase 2: every kernel against its plain version on the card."""
    from tpuparquet_torch.cpu.bitpack import pack
    from tpuparquet_torch.kernels.bitunpack import pad_to_words, \
        unpack_u32, unpack_u32_plain
    from tpuparquet_torch.kernels.decode import levels_to_validity, \
        levels_to_validity_plain, page_dict_fixed, page_dict_fixed_plain
    from tpuparquet_torch.kernels.hybrid import expand_hybrid, \
        expand_hybrid_plain

    rng = np.random.default_rng(7)
    n = 10_007
    for w in range(33):
        vals = rng.integers(0, (1 << w) - 1 if w else 0, size=n,
                            endpoint=True, dtype=np.uint64)
        words = torch.from_numpy(pad_to_words(
            np.frombuffer(pack(vals, w), np.uint8), max(w, 1), n)
            .reshape(-1).view(np.int32)).to(dev)
        got = unpack_u32(words, w, n)
        _same(f"K1 width {w}", got, unpack_u32_plain(words, w, n))
        if not np.array_equal(_u32(got), vals.astype(np.int64)):
            raise AssertionError(f"K1 width {w}: wrong values")
    for w in (1, 2, 3, 7, 13, 20, 31, 32):
        vals = _runny(rng, 50_000, w)
        bp, tbl, cnt, nbp = _stream(vals, w, dev)
        got = expand_hybrid(bp, tbl, cnt, w, nbp)
        _same(f"K2 width {w}", got, expand_hybrid_plain(bp, tbl, cnt, w, nbp))
        if not np.array_equal(_u32(got)[: vals.size], vals.astype(np.int64)):
            raise AssertionError(f"K2 width {w}: wrong values")
        one = _one_run(vals, w, cnt, dev)
        _same(f"K2 single width {w}", expand_hybrid(one, tbl, cnt, w, cnt,
                                                     single=True),
              expand_hybrid(one.cpu(), tbl.cpu(), cnt, w, cnt, single=True))
    for lanes in (1, 2):
        d = torch.from_numpy(rng.integers(-2**31, 2**31, size=37 * lanes,
                                          dtype=np.int64).astype(np.int32)
                             ).to(dev)
        for w, single in ((6, False), (6, True), (5, False)):
            # width 6 indexes up to 63 in a 37-entry dictionary: clamped
            idx = _runny(rng, 20_000, w)
            bp, tbl, cnt, nbp = _stream(idx, w, dev)
            if single:
                bp = _one_run(idx, w, cnt, dev)
            got = page_dict_fixed(d, bp, tbl, cnt, w, nbp, lanes, single)
            _same(f"K3 lanes {lanes} width {w} single {single}", got,
                  page_dict_fixed_plain(d, bp, tbl, cnt, w, nbp, lanes,
                                        single))
        got = page_dict_fixed(d, None, None, 1000, 0, 0, lanes)
        _same(f"K3 lanes {lanes} width 0", got,
              page_dict_fixed_plain(d, None, None, 1000, 0, 0, lanes))
    for size in (1, 1023, 1025, (1 << 21) + 3):
        dl = torch.from_numpy(rng.integers(0, 3, size=size).astype(
            np.int32)).to(dev)
        m, p = levels_to_validity(dl, 2)
        pm, pp = levels_to_validity_plain(dl, 2)
        _same(f"K4 mask {size}", m, pm)
        _same(f"K4 positions {size}", p, pp)
    _check_unpack_edges(rng, dev)
    _check_hybrid_edges(rng, dev)
    _check_levels_edges(rng, dev)
    _check_planes(rng, dev)
    _check_planes_edges(rng, dev)
    _check_unpack_u64(rng, dev)
    _check_delta_scan(rng, dev)
    _check_tokens(rng, dev)
    _check_dict_bytes(rng, dev)
    _check_bytes_from_blob(rng, dev)
    _check_delta_scatter(rng, dev)
    _check_bss(rng, dev)
    _check_bss_edges(rng, dev)
    _check_flba(rng, dev)
    _check_new_shapes(rng, dev)
    _check_pack_bits(rng, dev)
    _check_pack_edges(rng, dev)
    _check_encode(rng, dev)
    _check_shard_kernels(rng, dev)
    if dev.type == "cuda":  # a fault during a run surfaces here
        torch.cuda.synchronize(dev)


def _time_ms(fn, reps: int = 20, budget_s: float | None = None) -> float:
    """CUDA-event ms of one call, the mean of ``reps`` after a warm call;
    with ``budget_s``, fewer reps (at least 1) where the warm call shows
    that ``reps`` would take longer than that."""
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    if budget_s is not None:
        warm = max(time.perf_counter() - t0, 1e-9)
        reps = max(1, min(reps, int(budget_s / warm)))
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def _bound_ms(n_bytes: int, n_ops: int):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / SCALAR_OPS_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations")


def _max_err(a: torch.Tensor, b: torch.Tensor) -> int:
    x, y = a.cpu().numpy(), b.cpu().numpy()
    if x.dtype == np.int32:
        x, y = x.view(np.uint32), y.view(np.uint32)
    return int(np.abs(x.astype(np.int64) - y.astype(np.int64)).max()) \
        if x.size else 0


def _kernel_row(out, launches, name, source, replaces, fn, plain, n_bytes,
                n_ops, library=None):
    """Hold a kernel against its plain version at a page shape, time both
    (and the library call) with CUDA events and the kernel and library
    call on the device (profiler), and append its row of the kernels
    line.  Returns the kernel's :func:`device_split`."""
    got, want = fn(), plain()
    if isinstance(got, tuple):
        err = max(_max_err(g, w) for g, w in zip(got, want))
    else:
        err = _max_err(got, want)
    if err != 0:
        raise AssertionError(f"{name}: kernel disagrees with its plain "
                             f"version at the page shape (max abs diff "
                             f"{err})")
    bound, by = _bound_ms(n_bytes, n_ops)
    ms, plain_ms = _time_ms(fn), _time_ms(plain, reps=5, budget_s=1.0)
    lib_ms = None if library is None else _time_ms(library)
    split = device_split(fn)
    out.append({"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches[name],
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound, "bound_by": by, "library_ms": lib_ms})
    lib = "" if lib_ms is None else (
        f"; library {lib_ms:.4f} ms, device {_us(device_split(library))} a "
        "call")
    print(f"{name}: {ms:.4f} ms, device {_us(split)} a call (bound "
          f"{bound:.4f} ms by {by}; plain {plain_ms:.4f} ms{lib}; "
          f"max_abs_err {err})", flush=True)
    return split


def _moved_per_input(src: torch.Tensor, n_in: int, n_out: int) -> float:
    """Device-memory bytes that K13's and KE2's designs move per input
    byte, by the designs' arithmetic (no counter is read): the 16-byte
    vectors that cover the input (one more at each end where ``src``
    starts off a 16-byte boundary) read once, and the output written
    once."""
    lead = src.data_ptr() & 15
    read = -(-(lead + n_in) // 16) * 16
    return (read + n_out) / n_in


def _flba_per_word(raw: torch.Tensor, count: int, length: int):
    """K13 forced to one thread a word (a tile of 0 rows), the path its
    wrapper takes only past 1,024 bytes a row: timed against the row
    tiles, it counts no launch."""
    from tpuparquet_torch.kernels._lib import launch, stream_of

    lanes = (length + 3) // 4
    out = torch.empty(count * lanes, dtype=torch.int32, device=raw.device)
    launch("flba_to_lanes", raw.data_ptr(), count, length, lanes, 0,
           out.data_ptr(), stream_of(out))
    return out


def flba_tiles_vs_words(count: int, dev) -> None:
    """K13's row tiles against one thread a word at the widths of a
    FIXED_LEN_BYTE_ARRAY DECIMAL (the format's least bytes for precision
    10-11, 12-14 and 15-16: 5, 6 and 7), ``count`` random rows each (the
    amount page's), both held against the plain version; device time
    from the profiler beside ``F.pad``'s and the bound.  No counted path
    has such rows, so this is printed and not a row of the kernels
    line."""
    from tpuparquet_torch.kernels.decode import flba_bytes_to_lanes, \
        flba_bytes_to_lanes_plain, flba_tile_rows

    g = torch.Generator(device=dev).manual_seed(29)
    for length in (5, 6, 7):
        lanes = (length + 3) // 4
        raw = torch.randint(0, 256, (count * length,), dtype=torch.uint8,
                            device=dev, generator=g)
        want = flba_bytes_to_lanes_plain(raw, count, length)
        paths = {
            "tiles": lambda: flba_bytes_to_lanes(raw, count, length),
            "one thread a word": lambda: _flba_per_word(raw, count, length),
            "F.pad": lambda: torch.nn.functional.pad(
                raw.view(count, length), (0, 4 * lanes - length)).view(
                    torch.int32),
        }
        for name in ("tiles", "one thread a word"):
            err = _max_err(paths[name](), want)
            if err:
                raise AssertionError(f"K13 L {length} {name}: max abs diff "
                                     f"{err} against the plain version")
        bound, _ = _bound_ms(count * length + 4 * lanes * count, 0)
        times = ", ".join(f"{name} {_us(device_split(fn))}"
                          for name, fn in paths.items())
        print(f"K13 L {length} ({count} rows, tile {flba_tile_rows(length)} "
              f"rows): {times} a call on the device; bound "
              f"{1e3 * bound:.1f} us; max_abs_err 0", flush=True)


def _stage(arrays, dev):
    return [_t(a, dev) for a in arrays]


def device_split(fn, reps: int = 10, tries: int = 3):
    """What one call of ``fn`` does on the device, from a torch.profiler
    trace: ``(us, launches, parts)``, its device time in microseconds
    (None when no trace holds any), the CUDA kernels, memsets and copies
    it launches, and each one's time as text.  A trace records ``reps``
    calls after ``reps`` traced and discarded ones, and each kernel's
    time is its mean over the launches recorded, times its launches a
    call: the tracer can miss launches while it starts, and now and then
    a whole window, which is then traced again, up to ``tries`` times."""
    import re

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        recorded = []
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1),
                     on_trace_ready=lambda p: recorded.extend(
                         p.key_averages())) as trace:
            for _ in range(2):
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
                trace.step()
        total, launches, parts = 0.0, 0, []
        for ev in recorded:  # the device's records, not host annotations
            if ev.device_type != DeviceType.CPU and ev.count \
                    and ev.self_device_time_total > 0:
                n = max(round(ev.count / reps), 1)
                us = ev.self_device_time_total / ev.count * n
                total += us
                launches += n
                name = re.search(r"::(\w+)[<(]", ev.key)
                parts.append(f"{name.group(1) if name else ev.key} "
                             f"{us:.1f} us")
        if parts:
            return total, launches, ", ".join(parts)
    return None, 0, "no device time traced"


def _us(split) -> str:
    return "not traced" if split[0] is None else f"{split[0]:.1f} us"


def k8_design(te_d, ts_d, lits_d, out_cap: int, end: int) -> dict:
    """What K8's design does on one page, from its token tables on the
    card: the doubling rounds its copy chains need (the reference runs
    ``steps`` whatever the data), the share of positions whose chain
    leaves their tile (resolved after the tile kernel), its CUDA launches
    per call, and the bytes it moves per output byte (tables and
    literals read once, each byte written once, the unresolved bitmask
    written and read, and for each unresolved position a 4-byte link
    written and read back and its target's byte read) beside the
    reference design's 8 * steps + 9."""
    from tpuparquet_torch.kernels.snappy import TILE, _resolved_map, \
        cuda_launches

    m = _resolved_map(te_d, ts_d, out_cap, 0)[:end]
    rounds = 0
    while bool((m >= 0).any()):
        nxt = m[torch.clamp(m, 0, end - 1).long()]
        m = torch.where(m >= 0, nxt, m)
        rounds += 1
    # the last position of each chain (the one whose link is a literal)
    m0 = _resolved_map(te_d, ts_d, out_cap, 0)[:end]
    i = torch.arange(end, dtype=torch.int64, device=m0.device)
    last = torch.where(m0 >= 0, m0.long(), i)
    while True:  # doubling: the literal's positions point at themselves
        nxt = last[last]
        if torch.equal(nxt, last):
            break
        last = nxt
    unresolved = float((last < (i // TILE) * TILE).float().mean())
    n_tiles = -(-end // TILE)
    tables = 4 * (te_d.numel() + ts_d.numel()) + lits_d.numel()
    per_byte = (tables / end + 1 + (0.25 if n_tiles > 1 else 0.125)
                + unresolved * 10)
    return {"rounds": rounds, "unresolved": unresolved,
            "launches": cuda_launches(end), "bytes_per_byte": per_byte}


def k1_page(pay_mask: np.ndarray, dev):
    """K1's phase-4 input: payment_type's def-level stream, which the
    planner re-packs as one bit-packed run (width 1, 2^21 lanes at
    1,250,000 rows): ``(words on dev, lanes, words as numpy)``."""
    from tpuparquet_torch.cpu.hybrid import encode_hybrid, scan_hybrid
    from tpuparquet_torch.kernels.hybrid import plan_stream_args

    n = pay_mask.size
    dl = pay_mask.astype(np.uint32)
    sc = scan_hybrid(encode_hybrid(dl, 1), n, 1)
    (bp, _tbl), cnt, _nbp, single = plan_stream_args(sc, n, 1)
    assert single
    return _t(bp, dev), cnt, bp


def k2_page(cols: dict, dev):
    """K2's phase-4 input: rate_code's dictionary-index stream, whose run
    table the planner keeps (width 3, 2^21 slots): ``(words, table) on
    dev, cnt, nbp, (words, table) as numpy, the stream's runs``."""
    from tpuparquet_torch.cpu.dictionary import build_dictionary
    from tpuparquet_torch.cpu.hybrid import encode_hybrid, scan_hybrid
    from tpuparquet_torch.kernels.hybrid import plan_stream_args

    n = cols["rate_code"].size
    _, idx = build_dictionary(cols["rate_code"])
    sc = scan_hybrid(encode_hybrid(idx.astype(np.uint32), 3), n, 3)
    (bp, tbl), cnt, nbp, single = plan_stream_args(sc, n, 3)
    assert not single
    return _t(bp, dev), _t(tbl, dev), cnt, nbp, (bp, tbl), len(sc[0])


def k1_moved(count: int, width: int) -> int:
    """Device-memory bytes K1's design moves: each packed word read once
    (a thread reads only the words that hold its lanes; words shared by
    neighbours come from the cache), each lane written once."""
    return 4 * (-(-count // 32) * width) + 4 * count


def k2_design(words: np.ndarray, table: np.ndarray, cnt: int):
    """What K2's design does on one page, from its staged numpy arrays:
    ``(moved, most)``, the device-memory bytes it moves by its arithmetic
    (the packed words read once; for each tile, a table of at most 32
    runs read whole, else two 32-way searches of the ends, the tile's
    range of runs at 12 bytes a run and the start of its first; each slot
    written once) and the most runs one tile meets."""
    from tpuparquet_torch.kernels.hybrid import hybrid_tile_slots

    t = hybrid_tile_slots()
    ends = table.reshape(4, -1)[0].view(np.int32)
    top = ends.size - 1
    firsts = np.arange(0, cnt, t)
    lasts = np.minimum(firsts + t, cnt) - 1
    rf = np.minimum(np.searchsorted(ends, firsts, side="right"), top)
    rl = np.minimum(np.searchsorted(ends, lasts, side="right"), top)
    runs = rl - rf + 1
    if ends.size <= 32:
        tables = firsts.size * 16 * ends.size
    else:
        rounds = -(-int(np.log2(ends.size)) // 5)
        tables = (firsts.size * (2 * rounds * 32 * 4 + 4)
                  + int(runs.sum()) * 12)
    return words.nbytes + tables + 4 * cnt, int(runs.max())


def k4_levels(pay_mask: np.ndarray, dev) -> torch.Tensor:
    """K4's phase-4 input: payment_type's def levels as the main path
    expands them, over the slots of K1's single bit-packed run (2^21 at
    1,250,000 rows), 0 past the rows."""
    from tpuparquet_torch.cpu.hybrid import encode_hybrid, scan_hybrid
    from tpuparquet_torch.kernels.hybrid import plan_stream_args

    n = pay_mask.size
    dl = pay_mask.astype(np.uint32)
    sc = scan_hybrid(encode_hybrid(dl, 1), n, 1)
    _, cnt, _, _ = plan_stream_args(sc, n, 1)
    levels = torch.zeros(cnt, dtype=torch.int32, device=dev)
    levels[:n] = torch.from_numpy(dl.astype(np.int32)).to(dev)
    return levels


def k4_moved(n: int) -> int:
    """Device-memory bytes K4's design moves for n slots, by its
    arithmetic: the def levels read once, the mask and positions written
    once, the memset of the tiles' status words, and each
    status word written twice and read by about 32 successors'
    look-back."""
    from tpuparquet_torch.kernels.decode import validity_tile_slots

    tiles = -(-n // validity_tile_slots())
    return 4 * n + 5 * n + 8 * tiles * (1 + 2 + 32)


def k5_page(cols: dict, dev):
    """K5's phase-4 input: trip_distance_mm's page of a config 2 row group
    through the port's plane planner, staged on ``dev``: ``(staged,
    arrays, spec, wire)``, the six device buffers, their numpy arrays as
    the stager holds them, the spec and the planner's wire bytes."""
    from tpuparquet_torch.kernels.device import _plan_plane_words, \
        _put_all, _Stager

    col = cols["trip_distance_mm"]
    stg = _Stager()
    planned = _plan_plane_words(np.ascontiguousarray(col).view(np.uint8),
                                col.size, 2, stg)
    assert planned is not None, "trip_distance_mm: planes rejected"
    wire, _, spec, _ = planned
    (staged,), _slab = _put_all([stg], dev)
    _sync(dev)  # the slab's copy is done before it goes
    return staged, [a for a, _ in stg.arrays], spec, wire


def k5_design(arrays, spec: tuple, count: int, lanes: int):
    """What K5's design does on one page, from its staged numpy arrays:
    ``(moved, most)``, the device-memory bytes it moves by its
    arithmetic (each raw slab read once, each tile's 32-way searches of
    its first and last value and its range of runs read once a run
    table, the output written once) and the most runs one run table holds
    in one tile."""
    from tpuparquet_torch.kernels.decode import planes_tile_values

    t = planes_tile_values()
    firsts = np.arange(0, count, t)
    lasts = np.minimum(firsts + t, count) - 1
    moved, most = 4 * count * lanes, 0
    for entry in spec:
        subs = entry[1:] if entry[0] == "bytes" else (entry,)
        for sub in subs:
            if sub[0] in ("raw32", "raw8"):
                moved += count * (4 if sub[0] == "raw32" else 1)
                continue
            ends = arrays[1 if sub[0] == "rle32" else 4][
                sub[1] : sub[1] + sub[2]]
            top = sub[2] - 1
            rf = np.minimum(np.searchsorted(ends, firsts, side="right"), top)
            rl = np.minimum(np.searchsorted(ends, lasts, side="right"), top)
            runs = rl - rf + 1
            most = max(most, int(runs.max()))
            rounds = max(-(-int(np.log2(max(sub[2], 2))) // 5), 1)
            moved += int(runs.sum()) * (8 if sub[0] == "rle32" else 5) \
                + firsts.size * 2 * rounds * 32 * 4
    return moved, most


def k12_moved(raw: torch.Tensor, count: int, k: int, lanes: int,
              tile: int = 0) -> float:
    """Device-memory bytes K12's design moves per output byte, by its
    arithmetic (no counter is read): for each tile of ``tile`` rows (the
    wrapper's by default) and each stream, the aligned 16-byte vectors
    that cover the stream's segment, read once, and each output word
    written once."""
    from tpuparquet_torch.kernels.decode import bss_lanes_tile_rows

    t = tile or bss_lanes_tile_rows(lanes)
    i0 = np.arange(0, count, t, dtype=np.int64)
    rows = np.minimum(t, count - i0)
    read = 0
    for s in range(k):
        d = (raw.data_ptr() + s * count + i0) & 15
        read += int((16 * ((d + rows + 15) // 16)).sum())
    return (read + 4 * lanes * count) / (4 * lanes * count)


def time_kernels(groups, mix_groups, groups4, groups_s, groups_t, groups_v2,
                 dev, launches) -> list:
    """Phase 4: each kernel at the main paths' page shapes."""
    from tpuparquet_torch.compress import compress_block
    from tpuparquet_torch.cpu.bss import encode_byte_stream_split
    from tpuparquet_torch.cpu.delta import encode_delta_binary_packed
    from tpuparquet_torch.cpu.dictionary import build_dictionary
    from tpuparquet_torch.cpu.hybrid import encode_hybrid, expand_scan, \
        scan_hybrid
    from tpuparquet_torch.cpu.plain import encode_plain
    from tpuparquet_torch.format.metadata import CompressionCodec, Type
    from tpuparquet_torch.kernels.bitunpack import pad_to_words, \
        unpack_tile_lanes, unpack_u32, unpack_u32_plain, unpack_u64, \
        unpack_u64_plain
    from tpuparquet_torch.cpu.delta import encode_delta_byte_array
    from tpuparquet_torch.cpu.plain import ByteArrayColumn
    from tpuparquet_torch.kernels.decode import bss_lanes_tile_rows, \
        bss_to_lanes, bss_to_lanes_plain, bucket, delta_scan, \
        delta_scan_plain, flba_bytes_to_lanes, flba_bytes_to_lanes_plain, \
        levels_to_validity, levels_to_validity_plain, page_dict_bytes, \
        page_dict_bytes_plain, page_dict_fixed, page_dict_fixed_plain, \
        plain_bytes_from_blob, plain_bytes_from_blob_plain, \
        plan_delta_i64, planes_tile_values, planes_to_words, \
        planes_to_words_plain, scatter_deltas, scatter_deltas_plain, \
        validity_tile_slots
    from tpuparquet_torch.kernels.device import _plan_dba_page, _put_all, \
        _Stager
    from tpuparquet_torch.kernels.hybrid import expand_hybrid, \
        expand_hybrid_plain, hybrid_tile_slots, plan_stream_args
    from tpuparquet_torch.kernels.snappy import expand_tokens, \
        expand_tokens_plain, expand_tokens_words, \
        expand_tokens_words_plain, plan_tokens
    from tpuparquet_torch.native import pack_native

    cols, pay_mask = groups[0]
    n = pay_mask.size
    out = []

    def row(*args, **kw):
        return _kernel_row(out, launches, *args, **kw)

    # K1: payment_type's def-level stream, which the planner re-packs as
    # one bit-packed run (width 1, 2^21 slots)
    bp_d, cnt, bp = k1_page(pay_mask, dev)
    split = row("unpack_u32", "tpuparquet_torch/csrc/unpack_u32.cu",
                "tpuparquet/kernels/bitunpack.py:208",
                lambda: unpack_u32(bp_d, 1, cnt),
                lambda: unpack_u32_plain(bp_d, 1, cnt),
                bp.nbytes + 4 * cnt, 8 * cnt)
    print(f"K1 page: width 1, {cnt} lanes, tiles of {unpack_tile_lanes()}; "
          f"{split[1]:g} CUDA launches a call ({split[2]}); "
          f"{k1_moved(cnt, 1) / (4 * cnt):.4f} bytes moved per output byte "
          "by the design's arithmetic", flush=True)
    # K2 and K3: rate_code's dictionary-index stream, a run table
    # (width 3, 2^21 slots), the table-mode expansion of the main path
    bp_d, tbl_d, cnt, nbp, (bp, tbl), n_runs = k2_page(cols, dev)
    split = row("expand_hybrid", "tpuparquet_torch/csrc/expand_hybrid.cu",
                "tpuparquet/kernels/hybrid.py:181",
                lambda: expand_hybrid(bp_d, tbl_d, cnt, 3, nbp),
                lambda: expand_hybrid_plain(bp_d, tbl_d, cnt, 3, nbp),
                bp.nbytes + tbl.nbytes + 4 * cnt, 8 * cnt)
    moved, most = k2_design(bp, tbl, cnt)
    print(f"K2 page: width 3, {cnt} slots, {n_runs} runs in a table of "
          f"{tbl.size // 4}, at most {most} runs in a tile of "
          f"{hybrid_tile_slots()} slots; {split[1]:g} CUDA launches a call "
          f"({split[2]}); {moved / (4 * cnt):.4f} bytes moved per output "
          "byte by the design's arithmetic", flush=True)
    dvals, _ = build_dictionary(cols["rate_code"])
    # the dictionary as staged: first-occurrence order, zero-padded to
    # its bucket; K3 gathers from the indices K2 expanded (a run of
    # width 32), the launch the main path makes for this page.  One
    # PyTorch call computes that gather
    dictionary = np.zeros(32, dtype=np.int32)
    dictionary[: dvals.size] = dvals
    (dict_d,) = _stage([dictionary], dev)
    idx_d = expand_hybrid(bp_d, tbl_d, cnt, 3, nbp)
    row("page_dict_fixed", "tpuparquet_torch/csrc/page_dict_fixed.cu",
        "tpuparquet/kernels/decode.py:311",
        lambda: page_dict_fixed(dict_d, idx_d, None, cnt, 32, cnt, 1, True),
        lambda: page_dict_fixed_plain(dict_d, idx_d, None, cnt, 32, cnt, 1,
                                      True),
        dict_d.numel() * 4 + 4 * cnt + 4 * cnt, 8 * cnt,
        library=lambda: torch.index_select(dict_d, 0, idx_d))
    # K4: payment_type's expanded def levels (2^21 slots); one PyTorch
    # call computes its core, the running count of the mask
    levels = k4_levels(pay_mask, dev)
    slots = levels.numel()
    mask_d = levels == 1
    split = row("levels_to_validity",
                "tpuparquet_torch/csrc/levels_to_validity.cu",
                "tpuparquet/kernels/decode.py:185",
                lambda: levels_to_validity(levels, 1),
                lambda: levels_to_validity_plain(levels, 1),
                4 * slots + slots + 4 * slots, 12 * slots,
                library=lambda: torch.cumsum(mask_d, 0, dtype=torch.int32))
    print(f"K4 page: {slots} slots, tiles of {validity_tile_slots()}; "
          f"{split[1]:g} CUDA launches a call ({split[2]}); "
          f"{k4_moved(slots) / (5 * slots):.4f} bytes moved per output byte "
          "by the design's arithmetic", flush=True)

    # K5: trip_distance_mm's page through the port's plane planner
    staged, arrays, spec, wire = k5_page(cols, dev)
    cpu_staged = [t.cpu() for t in staged]
    split = row("planes_to_words", "tpuparquet_torch/csrc/planes_to_words.cu",
                "tpuparquet/kernels/decode.py:127",
                lambda: planes_to_words(*staged, spec, n, 2),
                lambda: planes_to_words_plain(*cpu_staged, spec, n, 2),
                wire + 8 * n, 2 * n * 8)
    moved, most = k5_design(arrays, spec, n, 2)
    print(f"K5 page: spec {spec}, wire {wire} bytes, at most {most} runs a "
          f"table in a tile of {planes_tile_values()} values; "
          f"{split[1]:g} CUDA launches a call ({split[2]}); "
          f"{moved / (8 * n):.4f} bytes moved per output byte by the "
          "design's arithmetic", flush=True)

    # K6: wide_delta's page, its deltas' offsets packed at width 39
    mix_cols, _ = mix_groups[0]
    m = mix_cols["wide_delta"].size
    v = mix_cols["wide_delta"].view(np.uint64)
    d = (v[1:] - v[:-1]).view(np.int64)
    off = (d - d.min()).view(np.uint64)
    w = int(off.max()).bit_length()
    n_pad = -(-(m - 1) // 32768) * 32768
    off_p = np.zeros(n_pad, np.uint64)
    off_p[: m - 1] = off
    words = pad_to_words(pack_native().pack(off_p, w), w, n_pad)
    (words_d,) = _stage([words], dev)
    words_c = words_d.cpu()
    row("unpack_u64", "tpuparquet_torch/csrc/unpack_u64.cu",
        "tpuparquet/kernels/bitunpack.py:143",
        lambda: unpack_u64(words_d, w, n_pad),
        lambda: unpack_u64_plain(words_c, w, n_pad),
        words.nbytes + 8 * n_pad, 20 * n_pad)
    print(f"K6 page: width {w}, {n_pad} values", flush=True)

    # K7: pickup_ts's page: the placed delta offsets and min_delta, the
    # scan that rebuilds the values; one PyTorch call computes its core,
    # the running sum of the int64 deltas
    v = cols["pickup_ts"].view(np.uint64)
    d = (v[1:] - v[:-1]).view(np.int64)
    md = int(d.min())
    off = (d - md).view(np.uint64)
    dlo, dhi = _stage([(off & np.uint64(0xFFFFFFFF)).astype(np.uint32),
                       (off >> np.uint64(32)).astype(np.uint32)], dev)
    md_u = np.uint64(md & 0xFFFFFFFFFFFFFFFF)
    md_lo, md_hi = _stage([np.array([md_u & np.uint64(0xFFFFFFFF)], np.uint32),
                           np.array([md_u >> np.uint64(32)], np.uint32)], dev)
    first = int(v[0])
    cpu_args = [t.cpu() for t in (dlo, dhi, md_lo, md_hi)]
    deltas64 = torch.from_numpy(d.copy()).to(dev)
    nd = n - 1
    split = row("delta_scan", "tpuparquet_torch/csrc/delta_scan.cu",
                "tpuparquet/kernels/decode.py:572",
                lambda: delta_scan(dlo, dhi, md_lo, md_hi, nd, first, n),
                lambda: delta_scan_plain(*cpu_args, nd, first, n),
                8 * nd + 8 + 8 * n, 4 * nd,
                library=lambda: torch.cumsum(deltas64, 0))
    # the design's traffic: the deltas and min_delta read once, the values
    # written once, and for each 4,096-value tile (csrc/delta_scan.cu) its
    # flag (zeroed, written, read) and its two u64 sums
    tiles = -(-n // 4096)
    moved = 8 * nd + 8 + 8 * n + tiles * (3 * 4 + 2 * 8)
    print(f"K7 pickup_ts page ({n} values): {split[1]:g} CUDA launches a "
          f"call ({split[2]}); {moved / n:.2f} bytes moved per value (the "
          f"function's {(16 * nd + 8 + 8) / n:.2f})", flush=True)
    got = delta_scan(dlo, dhi, md_lo, md_hi, nd, first, n)
    if not np.array_equal(got.cpu().numpy().view(np.int64),
                          cols["pickup_ts"]):
        raise AssertionError("K7 pickup_ts page: wrong values")

    # K8: tok's page (its PLAIN values, snappy-compressed as the writer
    # does), resolved into the page's u32 words.  The function reads the
    # token tables and literals once, writes the words once, and does
    # about one operation per output byte; the search and the doubling
    # rounds are the design's, not the function's
    page = np.ascontiguousarray(mix_cols["tok"]).view(np.uint8)
    comp = compress_block(CompressionCodec.SNAPPY, page)
    te, ts, lp, out_cap, steps, out_len = plan_tokens(comp, page.size)
    te_d, ts_d, lp_d = _stage([te, ts, lp], dev)
    cpu_tok = [t.cpu() for t in (te_d, ts_d, lp_d)]
    nw = out_len // 4
    row("expand_tokens", "tpuparquet_torch/csrc/snappy_expand.cu",
        "tpuparquet/kernels/snappy.py:96",
        lambda: expand_tokens_words(te_d, ts_d, lp_d, out_cap, steps, 0, nw),
        lambda: expand_tokens_words_plain(*cpu_tok, out_cap, steps, 0, nw),
        te.nbytes + ts.nbytes + lp.nbytes + 4 * nw, 4 * nw)
    split = device_split(lambda: expand_tokens_words(
        te_d, ts_d, lp_d, out_cap, steps, 0, nw))[2]
    print(f"K8 tok page, device time a call: {split}", flush=True)
    dz = k8_design(te_d, ts_d, lp_d, out_cap, 4 * nw)
    print(f"K8 page: {te.size} tokens, {lp.size} literal bytes, out_cap "
          f"{out_cap}; chain depth {dz['rounds']} doubling rounds (the "
          f"reference runs {steps}); {100 * dz['unresolved']:.2f}% of "
          f"positions leave their tile; {dz['launches']} CUDA launches a "
          f"call; {dz['bytes_per_byte']:.2f} bytes moved per output byte "
          f"(the reference design {8 * steps + 9})", flush=True)

    # K9: config 4's vendor page (row group 0), planned as the reader
    # plans it: the dictionary staged padded, the indices expanded on the
    # host for the offsets, the index stream shipped for K9.  One PyTorch
    # call computes the core of its offsets: the running sum of the
    # values' lengths
    vendor = groups4[0][0]["vendor"]
    d, idx = build_dictionary(vendor)
    nn = len(vendor)
    w = max((len(d) - 1).bit_length(), 1)
    sc = scan_hybrid(encode_hybrid(idx.astype(np.uint32), w), nn, w)
    idx_u = expand_scan(*sc[:6], nn, w)
    (bp, tbl), cnt, nbp, single = plan_stream_args(sc, nn, w,
                                                   expanded=idx_u)
    lens = d.lengths()[idx_u]
    total_b = int(lens.sum())
    cap = bucket(total_b)
    stg = _Stager()
    stg.add_many([d.offsets.astype(np.int32), d.data])
    stg.add_many([bp, tbl], pad=False)
    ((doffs, ddata, bp_d, tbl_d),), _slab = _put_all([stg], dev)
    _sync(dev)
    lens_d = torch.from_numpy(lens.astype(np.int32)).to(dev)
    row("page_dict_bytes", "tpuparquet_torch/csrc/dict_bytes.cu",
        "tpuparquet/kernels/decode.py:333",
        lambda: page_dict_bytes(doffs, ddata, bp_d, tbl_d, nn, cnt, w, nbp,
                                cap, single),
        lambda: page_dict_bytes_plain(doffs, ddata, bp_d, tbl_d, nn, cnt, w,
                                      nbp, cap, single),
        4 * doffs.numel() + ddata.numel() + bp.nbytes + tbl.nbytes + cap,
        2 * cnt + cap,
        library=lambda: torch.cumsum(lens_d, 0, dtype=torch.int32))
    got = page_dict_bytes(doffs, ddata, bp_d, tbl_d, nn, cnt, w, nbp, cap,
                          single)
    if not np.array_equal(got[:total_b].cpu().numpy(), vendor.data):
        raise AssertionError("K9 vendor page: wrong bytes")
    split = device_split(lambda: page_dict_bytes(
        doffs, ddata, bp_d, tbl_d, nn, cnt, w, nbp, cap, single))[2]
    print(f"K9 vendor page, device time a call: {split}", flush=True)
    # the design's traffic: the packed indices read twice (sums, copy),
    # each output byte written once, the block sums; the dictionary and
    # its offsets are L2-resident
    n_blocks = -(-cnt // 4096)
    moved = 2 * bp.nbytes + cap + 4 * n_blocks * (n_blocks + 1)
    print(f"K9 page: {nn} values, {total_b} bytes out (cap {cap}), index "
          f"width {w}, single run {single}; 2 CUDA launches a call (the "
          f"reference design 4); {moved / cap:.3f} bytes moved per output "
          f"byte beside the dictionary's L2 reads", flush=True)

    # K10: the string mix's url page (row group 0): its PLAIN records,
    # snappy-compressed as the writer does, expanded by K8 into the blob
    # K10 reads, as on the main path
    url = groups_s[0][0]["url"]
    page = np.frombuffer(encode_plain(Type.BYTE_ARRAY, url), np.uint8)
    comp = compress_block(CompressionCodec.SNAPPY, page)
    te, ts, lp, out_cap, steps, _ = plan_tokens(comp, page.size)
    blob_d = expand_tokens(*_stage([te, ts, lp], dev), out_cap, steps)
    nn, nb = len(url), url.data.size
    offs_pad = np.full(bucket(nn + 1), nb, dtype=np.int32)
    offs_pad[: nn + 1] = url.offsets
    (offs_d,) = _stage([offs_pad], dev)
    cap = bucket(nb)
    split = row("plain_bytes_from_blob",
                "tpuparquet_torch/csrc/bytes_from_blob.cu",
                "tpuparquet/kernels/decode.py:361",
                lambda: plain_bytes_from_blob(blob_d, offs_d, 0, cap),
                lambda: plain_bytes_from_blob_plain(blob_d, offs_d, 0, cap),
                nb + offs_pad.nbytes + cap, cap)
    got = plain_bytes_from_blob(blob_d, offs_d, 0, cap)
    if not np.array_equal(got[:nb].cpu().numpy(), url.data):
        raise AssertionError("K10 url page: wrong bytes")
    print(f"K10 page: {nn} values, {nb} bytes out (cap {cap}), blob "
          f"{out_cap} bytes", flush=True)
    moved = k10_moved(nn, nb, cap, blob_d.numel(), 0, offs_pad.size)
    print(f"K10 url page: {split[1]:g} CUDA launches a call ({split[2]}); "
          f"{moved / cap:.2f} bytes moved per output byte by the design's "
          f"arithmetic", flush=True)

    # K11: the largest scattered width class of the sensor table's ts page
    # (row group 0), unpacked by K6 as on the main path and placed into
    # the page's delta stream.  One PyTorch call computes the same
    # placement: index_put_ of the kept lanes, as int64, at the masked
    # grid
    cols_t, _ = groups_t[0]
    plan = plan_delta_i64(encode_delta_binary_packed(cols_t["ts"]))
    w, words, starts, takes, n_vals, _, _ = max(
        (gr for gr in plan.groups if gr[2] is not None), key=lambda gr: gr[4])
    k = starts.size
    mb = n_vals // k
    out_len = plan.total - 1
    words_d, st_d, tk_d = _stage([words, starts, takes], dev)
    lo_d, hi_d = unpack_u64(words_d, w, n_vals)
    lane = np.arange(mb)[None, :]
    grid = starts.astype(np.int64)[:, None] + lane
    keep = (lane < takes[:, None]) & (grid < out_len)
    n_keep = int(keep.sum())
    keep_d = torch.from_numpy(keep.reshape(-1)).to(dev)
    pos_d = torch.from_numpy(grid[keep]).to(dev)
    v64_d = ((hi_d.to(torch.int64) << 32)
             | (lo_d.to(torch.int64) & 0xFFFFFFFF))[keep_d]
    d64 = torch.zeros(out_len, dtype=torch.int64, device=dev)
    kern = [torch.zeros(out_len, dtype=torch.int32, device=dev)
            for _ in range(2)]
    plain = [torch.zeros_like(kern[0]) for _ in range(2)]

    def k11():
        scatter_deltas(lo_d, hi_d, st_d, tk_d, n_vals, *kern, out_len)
        return tuple(kern)

    def k11_plain():
        scatter_deltas_plain(lo_d, hi_d, st_d, tk_d, n_vals, *plain,
                             out_len)
        return tuple(plain)

    row("scatter_deltas", "tpuparquet_torch/csrc/delta_scatter.cu",
        "tpuparquet/kernels/decode.py:491",
        k11, k11_plain, 8 * n_vals + 8 * k + 8 * n_keep, 6 * n_vals,
        library=lambda: d64.index_put_((pos_d,), v64_d))
    placed = ((kern[1].to(torch.int64) << 32)
              | (kern[0].to(torch.int64) & 0xFFFFFFFF))[pos_d]
    if not torch.equal(placed, v64_d):
        raise AssertionError("K11 ts page: lanes not at their targets")
    print(f"K11 page: width {w}, {k} miniblocks of {mb}, {n_keep} lanes "
          f"placed, {len(plan.groups)} width classes, "
          f"{sum(gr[2] is not None for gr in plan.groups)} scattered",
          flush=True)

    # K12: the sensor table's reading page (row group 0): 8 byte streams
    # of the non-null doubles.  One PyTorch call computes the transpose
    reading = cols_t["reading"]
    count = reading.size
    raw = np.frombuffer(encode_byte_stream_split(reading), np.uint8)
    (raw_d,) = _stage([raw], dev)
    split = row("bss_to_lanes", "tpuparquet_torch/csrc/bss_to_lanes.cu",
                "tpuparquet/kernels/decode.py:82",
                lambda: bss_to_lanes(raw_d, count, 8, 2),
                lambda: bss_to_lanes_plain(raw_d, count, 8, 2),
                2 * raw.nbytes, 12 * 2 * count,
                library=lambda: raw_d.view(8, count).t().contiguous())
    got = bss_to_lanes(raw_d, count, 8, 2)
    if not np.array_equal(got.cpu().numpy().view(np.float64), reading):
        raise AssertionError("K12 reading page: wrong values")
    print(f"K12 page: {count} doubles, {raw.nbytes} bytes", flush=True)
    print(f"K12 reading page: count % 16 = {count % 16}, tiles of "
          f"{bss_lanes_tile_rows(2)} rows; {split[1]:g} CUDA launches a "
          f"call ({split[2]}); {k12_moved(raw_d, count, 8, 2):.4f} bytes "
          "moved per output byte by the design's arithmetic", flush=True)

    # K13: the parquet-mr v2 table's amount page (row group 0): its
    # DELTA_BYTE_ARRAY tables planned as the reader plans them, expanded
    # by K8 into the rows K13 reads.  One PyTorch call computes the same
    # words: the rows zero-padded to whole lanes (F.pad), viewed as int32
    def dba_page(col, flba):
        n = len(col)
        seg = np.frombuffer(encode_delta_byte_array(col), np.uint8)
        stg = _Stager()
        _plan_dba_page(seg, flba, None, n, n, 0, stg)
        (staged,), _slab = _put_all([stg], dev)
        _sync(dev)
        expanded = int(col.offsets[-1])
        return (staged, bucket(expanded),
                max(int(np.ceil(np.log2(max(expanded, 2)))), 1), expanded)

    cols_v2, _ = groups_v2[0]
    rows = cols_v2["amount"]
    na, length = rows.shape
    lanes = (length + 3) // 4
    (te_d, ts_d, lits_d), cap, steps, _ = dba_page(
        ByteArrayColumn(np.arange(na + 1) * length, rows.reshape(-1)),
        length)
    blob_d = expand_tokens(te_d, ts_d, lits_d, cap, steps)
    split = row(
        "flba_bytes_to_lanes", "tpuparquet_torch/csrc/flba_to_lanes.cu",
        "tpuparquet/kernels/decode.py:99",
        lambda: flba_bytes_to_lanes(blob_d, na, length),
        lambda: flba_bytes_to_lanes_plain(blob_d, na, length),
        na * length + 4 * lanes * na, 8 * lanes * na,
        library=lambda: torch.nn.functional.pad(
            blob_d[: na * length].view(na, length),
            (0, 4 * lanes - length)).view(torch.int32))
    got = flba_bytes_to_lanes(blob_d, na, length)
    if not np.array_equal(got.cpu().numpy().view(np.uint8).reshape(
            na, 4 * lanes)[:, :length], rows):
        raise AssertionError("K13 amount page: wrong rows")
    print(f"K13 page: {na} rows of {length} bytes, {lits_d.numel()} "
          f"suffix bytes", flush=True)
    moved = _moved_per_input(blob_d, na * length, 4 * lanes * na)
    print(f"K13 amount page: {split[1]:g} CUDA launches a call "
          f"({split[2]}); {moved:.2f} bytes moved per input byte by the "
          f"design's arithmetic; count % 16 = {na % 16}", flush=True)
    flba_tiles_vs_words(na, dev)

    # K8 again on the same table's url page: the front-coding copy graph
    # of sorted URLs, one copy and one literal token a value (printed
    # here; the kernels line keeps K8's row of the tok page)
    url = cols_v2["url"]
    (te_d, ts_d, lits_d), cap, steps, expanded = dba_page(url, None)
    got, want = (expand_tokens(te_d, ts_d, lits_d, cap, steps),
                 expand_tokens_plain(te_d, ts_d, lits_d, cap, steps))
    err = _max_err(got, want)
    if err or not np.array_equal(got[:expanded].cpu().numpy(), url.data):
        raise AssertionError("K8 url page: wrong bytes")
    bound, by = _bound_ms(te_d.numel() * 8 + lits_d.numel() + expanded,
                          expanded)
    ms = _time_ms(lambda: expand_tokens(te_d, ts_d, lits_d, cap, steps))
    plain_ms = _time_ms(lambda: expand_tokens_plain(te_d, ts_d, lits_d, cap,
                                                    steps), reps=5)
    split = device_split(
        lambda: expand_tokens(te_d, ts_d, lits_d, cap, steps))[2]
    print(f"K8 url page, device time a call: {split}", flush=True)
    dz = k8_design(te_d, ts_d, lits_d, cap, cap)
    print(f"K8 url page: chain depth {dz['rounds']} doubling rounds (the "
          f"reference runs {steps}); {100 * dz['unresolved']:.2f}% of "
          f"positions leave their tile; {dz['launches']} CUDA launches a "
          f"call; {dz['bytes_per_byte']:.2f} bytes moved per output byte "
          f"(the reference design {8 * steps + 9})", flush=True)
    print(f"expand_tokens on the url page ({len(url)} values, {expanded} "
          f"bytes out, {lits_d.numel()} suffix bytes, {steps} rounds): "
          f"{ms:.4f} ms (bound {bound:.4f} ms by {by}; plain "
          f"{plain_ms:.4f} ms; max_abs_err {err})", flush=True)
    return out


def ke1_classes(phase):
    """The miniblock widths of an int64 delta page from its KE3 outputs
    (``delta_phase1``'s six lanes), as the delta encoder takes them:
    ``(widths, classes, sizes)``, each width class above 0 and its
    miniblock count."""
    from tpuparquet_torch.cpu.delta import widths_from_max

    mb_max = (phase[2].cpu().numpy().view(np.uint32).astype(np.uint64)
              | (phase[3].cpu().numpy().view(np.uint32).astype(np.uint64)
                 << np.uint64(32)))
    widths = widths_from_max(mb_max)
    classes, sizes = np.unique(widths[widths > 0], return_counts=True)
    return widths, classes, sizes


def time_encode_kernels(dv_t, dv_2, dev, launches) -> list:
    """Phase 4, the write side: KE1-KE5 at phase 5's page shapes (row
    group 0 of the sensor table and of config 2, as read on the card).
    The KE4 and KE5 times include reading their one or two result words
    back, as the wrappers do."""
    from tpuparquet_torch.kernels.encode import bss_encode_device, \
        bss_encode_plain, delta_phase1, delta_phase1_plain, dict_build, \
        dict_build_plain, lanes_min_max, lanes_min_max_plain, pack_bits, \
        pack_bits_plain

    out = []

    def row(*args, **kw):
        return _kernel_row(out, launches, *args, **kw)

    # KE3: the sensor table's ts page (int64, bursty timestamps); one
    # PyTorch call computes its core, the deltas (torch.diff)
    ts = dv_t[0][0]["ts"].flat
    count = ts.numel() // 2
    nb = (count - 2) // 128 + 1
    fn_bytes = 8 * count + 8 * nb * (1 + 4 + 128)
    split = row("delta_phase1", "tpuparquet_torch/csrc/delta_encode.cu",
                "tpuparquet/kernels/encode.py:195",
                lambda: delta_phase1(ts, count, False),
                lambda: delta_phase1_plain(ts, count, False),
                fn_bytes, 12 * count,
                library=lambda: torch.diff(ts.view(torch.int64)))
    # the design's traffic: the function's, and one extra value after each
    # warp's 4 blocks
    moved = fn_bytes + 8 * -(-nb // 4)
    print(f"KE3 ts page ({count} values): {split[1]:g} CUDA launches a "
          f"call ({split[2]}); {moved / count:.2f} bytes moved per value "
          f"(the function's {fn_bytes / count:.2f})", flush=True)
    phase = delta_phase1(ts, count, False)
    widths, classes, sizes = ke1_classes(phase)
    w = int(classes[np.argmax(sizes)])
    idx = np.nonzero(widths == w)[0]
    sel = torch.from_numpy(idx.astype(np.int32)).to(dev)
    alo, ahi = phase[4], phase[5]
    cnt = idx.size * 32
    # KE1: the ts page's largest width class, packed over its miniblocks
    split = row("pack_bits", "tpuparquet_torch/csrc/pack_bits.cu",
        "tpuparquet/kernels/encode.py:104",
        lambda: pack_bits(alo, ahi, w, cnt, sel=sel),
        lambda: pack_bits_plain(alo, ahi, w, cnt, sel=sel),
        cnt * (8 if w > 32 else 4) + 4 * idx.size + 4 * w * idx.size,
        4 * cnt)
    print(f"KE1 class: width {w}, {idx.size} of {widths.size} miniblocks "
          f"({classes.size} width classes)", flush=True)
    moved, parent, n_in = ke1_moved(w, idx.size)
    print(f"KE1 ts page class: {split[1]:g} CUDA launches a call "
          f"({split[2]}); {moved / n_in:.4f} bytes loaded and stored per "
          f"input byte by the design's arithmetic (the parent's "
          f"{parent / n_in:.4f})", flush=True)
    # KE2: the reading page (doubles), 8 byte streams; one PyTorch call
    # computes the transpose
    reading = dv_t[0][0]["reading"].flat
    nr = reading.numel() // 2
    split = row("bss_encode_device", "tpuparquet_torch/csrc/bss_encode.cu",
        "tpuparquet/kernels/encode.py:146",
        lambda: bss_encode_device(reading, nr, 8, 2),
        lambda: bss_encode_plain(reading, nr, 8, 2),
        16 * nr, 8 * nr,
        library=lambda: reading.view(torch.uint8).view(nr, 8).t()
        .contiguous())
    unaligned = sum(1 for st in range(8) if st * nr % 16)
    moved = _moved_per_input(reading, 8 * nr, 8 * nr)
    print(f"KE2 reading page ({nr} doubles): {split[1]:g} CUDA launches a "
          f"call ({split[2]}); {moved:.2f} bytes moved per input byte by "
          f"the design's arithmetic; "
          f"count % 16 = {nr % 16} ({unaligned} of 8 streams start off a "
          f"16-byte boundary)", flush=True)
    # KE5: the reading page's float min/max (NaN skipped); torch.aminmax
    # is timed only (its NaN handling differs)

    def keys(got):
        return torch.from_numpy(np.array(got, np.uint64).view(np.int64))

    split = row("lanes_min_max", "tpuparquet_torch/csrc/min_max.cu",
        "tpuparquet/kernels/encode.py:438",
        lambda: keys(lanes_min_max(reading, 2, "float")),
        lambda: keys(lanes_min_max_plain(reading, 2, "float")),
        8 * nr + 16, 6 * nr,
        library=lambda: torch.aminmax(reading.view(torch.float64)))
    moved, parent = ke5_moved(nr, 2, dev)
    print(f"KE5 reading page ({nr} doubles): {split[1]:g} CUDA operations "
          f"a call ({split[2]}; the parent's design 3: a one-thread init "
          f"kernel, the reduction, a 16-byte copy); {moved / (8 * nr):.4f} "
          f"bytes moved per input byte by the design's arithmetic (the "
          f"parent's {parent / (8 * nr):.4f})", flush=True)
    ke5_copied(reading, dev)
    # KE4: config 2's passenger_count page; one PyTorch call computes the
    # first-occurrence table (scatter_reduce_ "amin")
    pc = dv_2[0][0]["passenger_count"]
    n = pc.count
    lo, hi = (int(x) for x in pc.min_max())
    span = hi - lo + 1
    off = pc.flat.to(torch.int64) - lo
    ar = torch.arange(n, dtype=torch.int64, device=dev)
    split = row("dict_build", "tpuparquet_torch/csrc/dict_build.cu",
                "tpuparquet/kernels/encode.py:497",
                lambda: dict_build(pc.flat, 1, n, lo & 0xFFFFFFFF, span)[::2],
                lambda: dict_build_plain(pc.flat, 1, n, lo & 0xFFFFFFFF,
                                         span)[::2],
                8 * n + 4 * span, 10 * n,
                library=lambda: torch.full((span,), n, dtype=torch.int64,
                                           device=dev).scatter_reduce_(
                    0, off, ar, "amin"))
    print(f"KE4 page: {n} values over a range of {span}", flush=True)
    print(f"KE4 passenger_count page: {split[1]:g} CUDA launches a call "
          f"({split[2]}); {ke4_moved(n, 1, span) / n:.2f} bytes moved per "
          f"value by the design's arithmetic", flush=True)
    dict_build_uniform(dev)
    return out


def ke1_moved(w: int, nb: int):
    """KE1 on ``nb`` full miniblocks of width ``w`` from a miniblock list:
    ``(design, parent, input)``, the bytes that this design's and the
    parent's threads load and store, by their arithmetic, and the input's
    bytes (the values and the list).  This design loads each value and
    list entry once and stores each word once; the parent's one thread a
    word loaded the list entry and every value that overlaps its word
    (through the cache: device memory sees fewer)."""
    from tpuparquet_torch.kernels.encode import _pack_tables

    vb = 8 if w > 32 else 4
    n_in = nb * (32 * vb + 4)
    design = n_in + 4 * w * nb
    touched = sum(len(c) for c in _pack_tables(w))
    parent = nb * (w * 4 + touched * vb + 4 * w)
    return design, parent, n_in


def ke5_moved(n: int, lanes: int, dev):
    """KE5 on ``n`` values of ``lanes`` words: ``(design, parent)``, the
    device-memory bytes this design and the parent move by their
    arithmetic.  This design: the values, each block's two 8-byte
    atomics and 4-byte ticket (a block a 1,024 vectors, at most 8 an SM),
    the last block's exchange of the fold and the two keys it writes; the
    parent: the init kernel's two keys, the values, each block's two
    8-byte atomics, the 16-byte copy."""
    per = 4 // lanes
    grid = min(8 * torch.cuda.get_device_properties(dev).multi_processor_count,
               max(-(-(n // per) // 1024), 1))
    design = 4 * lanes * n + grid * (16 + 4) + 16 + 16
    parent_grid = min(-(-n // 256), 1056)
    return design, 16 + 4 * lanes * n + 16 * parent_grid + 16


def ke5_copied(reading, dev) -> None:
    """KE5 on phase 4's reading page with its keys written to device
    memory and copied into the pinned buffer (cudaMemcpyAsync), the
    readback the mapped buffer replaced, held against the plain version
    and timed beside the wrapper's."""
    from tpuparquet_torch.kernels._lib import launch, stream_of
    from tpuparquet_torch.kernels.encode import _min_max_state, \
        lanes_min_max, lanes_min_max_plain

    nr = reading.numel() // 2
    stream = stream_of(reading)
    st = _min_max_state(dev, stream)
    keys_d = torch.empty(2, dtype=torch.int64, device=dev)

    def copied():
        launch("min_max", reading.data_ptr(), nr, 2, 2,
               st.scratch.data_ptr(), keys_d.data_ptr(), stream)
        st.host.copy_(keys_d, non_blocking=True)
        launch("min_max_wait", stream)
        return int(st.keys[0]), int(st.keys[1])

    def mapped():
        return lanes_min_max(reading, 2, "float")

    want = lanes_min_max_plain(reading, 2, "float")
    for label, fn in (("keys to the mapped buffer (the wrapper's)", mapped),
                      ("keys copied by cudaMemcpyAsync", copied)):
        got = fn()
        if label.startswith("keys copied"):  # the keys, not yet unkeyed
            got = tuple(k ^ (1 << 63) if k >> 63 else k ^ (2**64 - 1)
                        for k in got)
        if got != want:
            raise AssertionError(f"KE5 {label}: {got}, plain {want}")
        split = device_split(fn, tries=6)
        print(f"KE5 design, {label}: {_time_ms(fn):.4f} ms, device "
              f"{_us(split)} a call, {split[1]:g} CUDA operations "
              f"({split[2]})", flush=True)


# KE5's ends that its design did not take, each in place of the kernel's
# own from its block reduction to its end: partials (a slot a block,
# reduced by the block that takes the last ticket) and every block's
# partial written straight to the mapped host buffer (reduced by the
# host, no ticket)
_KE5_TAIL = "  block_min_max(mn, mx);\n  if (threadIdx.x != 0) return;"
_KE5_PARTIALS = """  block_min_max(mn, mx);
  __shared__ bool last;
  u64* part = acc + 3;
  if (threadIdx.x == 0) {
    part[2 * blockIdx.x] = mn;
    part[2 * blockIdx.x + 1] = mx;
    __threadfence();
    last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  mn = ~0ull;
  mx = 0ull;
  for (int b = threadIdx.x; b < static_cast<int>(gridDim.x); b += kThreads) {
    const u64 a = __ldcg(part + 2 * b), c = __ldcg(part + 2 * b + 1);
    mn = a < mn ? a : mn;
    mx = c > mx ? c : mx;
  }
  block_min_max(mn, mx);
  if (threadIdx.x != 0) return;
  *ticket = 0u;
  *reinterpret_cast<ulonglong2*>(out) = make_ulonglong2(mn, mx);
  __threadfence_system();
}

"""
_KE5_HOST_FOLD = """  block_min_max(mn, mx);
  if (threadIdx.x != 0) return;
  reinterpret_cast<ulonglong2*>(out)[blockIdx.x] = make_ulonglong2(mn, mx);
}

"""


def _variant(stem: str, edit) -> str:
    """The text of ``csrc/<stem>.cu`` after ``edit`` (a function of the
    text), which raises when the source no longer has what it edits."""
    from tpuparquet_torch._build import CSRC

    return edit((CSRC / f"{stem}.cu").read_text())


def _sub(old: str, new: str):
    def edit(text: str) -> str:
        if old not in text:
            raise AssertionError(f"a design variant expects {old!r}")
        return text.replace(old, new)
    return edit


def _span(start: str, end: str, new: str):
    """An edit that puts ``new`` in place of the text from ``start`` up to
    ``end``; it raises when the source no longer holds either."""
    def edit(text: str) -> str:
        a, b = text.index(start), text.index(end)
        return text[:a] + new + text[b:]
    return edit


def _tail(new: str):
    return _span(_KE5_TAIL, "using Kernel = void (*)", new)


def _build_variants(sources: dict) -> dict:
    """Compile each variant text (name -> (stem, text)) beside the
    package's builds, in parallel, and bind its ``tpq_<stem>``."""
    import ctypes

    from tpuparquet_torch._build import BUILD_DIR, CSRC, build, find_nvcc
    from tpuparquet_torch.kernels._lib import KERNELS, NVCC_FLAGS

    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for name, (stem, text) in sources.items():
        src = BUILD_DIR / f"variant_{name}.cu"
        src.write_text(text)
        jobs.append((src, [find_nvcc()] + NVCC_FLAGS + ["-I", str(CSRC)]))
    fns = {}
    for (name, (stem, _)), path in zip(sources.items(), build(jobs)):
        fn = getattr(ctypes.CDLL(str(path)), f"tpq_{stem}")
        fn.argtypes, fn.restype = KERNELS[stem], ctypes.c_int
        fns[name] = fn
    return fns


def encode_variants(dev, n_values: int = 50_000_000,
                    n_groups: int = 8) -> None:
    """KE1 and KE5 built with what their designs left behind, from this
    checkout's sources edited in place of one constant or one block of
    code, timed on the device beside the kernels as built (phase 4's
    inputs, rebuilt from the sensor table's generator): KE1 with blocks
    of 64, 128 and 256 threads at 1, 2, 4 and 8 miniblocks a warp, on
    the ts page's largest and smallest width classes and, over the
    largest class's miniblocks, at widths 7 and 64; KE5 on the
    reading page with 2, 4 and 8 loads a thread in flight and blocks of
    256 and 512 threads (each but the kernel's own), without the system
    fence after the keys' store, with the partials reduced by the last
    block, and with every block's partial written to the host, which
    reduces them.  Each is held against the plain version."""
    import ctypes
    import re

    from tpuparquet_torch.kernels import _lib
    from tpuparquet_torch.kernels._lib import launch, stream_of
    from tpuparquet_torch.kernels.encode import _min_max_state, \
        delta_phase1, lanes_min_max_plain, pack_bits_plain

    def const(stem: str, name: str) -> int:
        return int(re.search(rf"constexpr int {name} = (\d+);",
                             _variant(stem, lambda t: t)).group(1))

    def with_consts(stem: str, **values) -> str:
        edits = [_sub(f"constexpr int {k} = {const(stem, k)};",
                      f"constexpr int {k} = {v};") for k, v in values.items()]
        text = _variant(stem, lambda t: t)
        for edit in edits:
            text = edit(text)
        return text

    built = (const("pack_bits", "kThreads"), const("pack_bits", "kPerWarp"))
    shapes = [(t, m) for t in (64, 128, 256) for m in (1, 2, 4, 8)]
    mm_threads, mm_unroll = (const("min_max", "kThreads"),
                             const("min_max", "kUnroll"))
    sources = {
        **{f"pack_bits {t} {m}": ("pack_bits", with_consts(
            "pack_bits", kThreads=t, kPerWarp=m))
           for t, m in shapes if (t, m) != built},
        **{f"min_max unroll {u}": ("min_max", with_consts(
            "min_max", kUnroll=u)) for u in (2, 4, 8) if u != mm_unroll},
        **{f"min_max threads {t}": ("min_max", with_consts(
            "min_max", kThreads=t)) for t in (256, 512) if t != mm_threads},
        "min_max without the system fence": ("min_max", _variant(
            "min_max", _sub("  __threadfence_system();\n", ""))),
        "min_max partials": ("min_max", _variant("min_max",
                                                 _tail(_KE5_PARTIALS))),
        "min_max host fold": ("min_max", _variant("min_max",
                                                  _tail(_KE5_HOST_FOLD))),
    }
    _lib.build_kernels()
    fns = _build_variants(sources)
    fns["pack_bits {} {}".format(*built)] = _lib._fns["pack_bits"]
    cols, _ = sensor_groups(n_values // 4 // n_groups, 1)[0]
    ts = _t(cols["ts"], dev)
    phase = delta_phase1(ts, ts.numel() // 2, False)
    widths, classes, sizes = ke1_classes(phase)
    alo, ahi = phase[4], phase[5]

    def sel_of(width):
        idx = np.nonzero(widths == width)[0]
        return torch.from_numpy(idx.astype(np.int32)).to(dev), 32 * idx.size

    big = int(classes[np.argmax(sizes)])
    small = int(classes[np.argmin(sizes)])
    shapes_w = [(f"class {big}", big, *sel_of(big)),
                (f"class {small}", small, *sel_of(small)),
                *((f"width {w}", w, *sel_of(big)) for w in (7, 64))]
    for t, m in shapes:
        fn = fns[f"pack_bits {t} {m}"]
        row = []
        for label, w, sel, cnt in shapes_w:
            want = pack_bits_plain(alo, ahi, w, cnt, sel=sel)
            out = torch.empty_like(want)

            def call(fn=fn, w=w, out=out, m=m, sel=sel, cnt=cnt):
                rc = fn(alo.data_ptr(), ahi.data_ptr(), alo.numel(),
                        sel.data_ptr(), cnt, w, m, out.data_ptr(),
                        stream_of(out))
                if rc:
                    raise RuntimeError(f"KE1 variant: cudaError {rc}")
                return out

            _same(f"KE1 blocks of {t}, {m} a warp, {label}", call(), want)
            row.append(f"{label} ({cnt // 32} miniblocks) "
                       f"{_us(device_split(call, tries=6))}")
        mark = " (the kernel as built)" if (t, m) == built else ""
        print(f"KE1 variant, blocks of {t} threads, {m} miniblocks a "
              f"warp{mark}: {', '.join(row)}", flush=True)
    reading = _t(cols["reading"], dev)
    nr = reading.numel() // 2
    want = lanes_min_max_plain(reading, 2, "float")
    stream = stream_of(reading)
    st = _min_max_state(dev, stream)
    # a slot for every block the card could hold (2,048 threads an SM);
    # the host fold's slots of blocks that do not run keep (~0, 0)
    slots = 8 * torch.cuda.get_device_properties(dev).multi_processor_count
    wide = torch.zeros(2 * slots, dtype=torch.int64, pin_memory=True)
    ptr = ctypes.c_uint64()
    launch("min_max_mapped", wide.data_ptr(), ctypes.byref(ptr))
    parts = wide.numpy().view(np.uint64)
    parts[0::2] = ~np.uint64(0)
    for name, fn in fns.items():
        if not name.startswith("min_max"):
            continue
        host = name == "min_max host fold"
        scratch = torch.zeros(3 + 2 * slots, dtype=torch.int64, device=dev)

        def call(fn=fn, host=host, scratch=scratch):
            rc = fn(reading.data_ptr(), nr, 2, 2, scratch.data_ptr(),
                    ptr.value if host else st.out_ptr, stream)
            if rc:
                raise RuntimeError(f"KE5 variant: cudaError {rc}")
            launch("min_max_wait", stream)
            if host:
                return int(parts[0::2].min()), int(parts[1::2].max())
            return int(st.keys[0]), int(st.keys[1])

        got = tuple(k ^ (1 << 63) if k >> 63 else k ^ (2**64 - 1)
                    for k in call())
        if got != want:
            raise AssertionError(f"KE5 variant {name}: {got}, plain {want}")
        print(f"KE5 variant, {name[8:]}: {_time_ms(call):.4f} ms, device "
              f"{_us(device_split(call, tries=6))} a call", flush=True)


def encode_kernel_splits(dev, n_values: int = 50_000_000,
                         n_groups: int = 8) -> None:
    """KE1 and KE5 alone at phase 4's shapes, their inputs rebuilt from
    the sensor table's generator (row group 0): KE1 on the ts page's
    largest and smallest width classes, and on the largest class's
    miniblocks at widths 1, 7, 33 and 64; KE5 on the reading page
    (doubles, float order) and on the seq page (int32, signed).  Each is
    held against its plain version, with its device time and CUDA
    operations a call.  Calls only ``encode.delta_phase1``,
    ``encode.pack_bits`` and ``encode.lanes_min_max``, whose signatures
    the parent shares, so the same function loaded from this checkout's
    chip_smoke.py (importlib, by path) times an older checkout's kernels
    from that checkout's directory."""
    from tpuparquet_torch.kernels.encode import delta_phase1, \
        lanes_min_max, lanes_min_max_plain, pack_bits, pack_bits_plain

    cols, _ = sensor_groups(n_values // 4 // n_groups, 1)[0]
    ts = _t(cols["ts"], dev)
    count = ts.numel() // 2
    phase = delta_phase1(ts, count, False)
    widths, classes, sizes = ke1_classes(phase)
    alo, ahi = phase[4], phase[5]

    def sel_of(width):
        idx = np.nonzero(widths == width)[0]
        return torch.from_numpy(idx.astype(np.int32)).to(dev), idx.size

    big = int(classes[np.argmax(sizes)])
    small = int(classes[np.argmin(sizes)])
    calls = []
    for label, cls, w in [("largest class", big, big),
                          ("smallest class", small, small)] + [
            (f"width {w}", big, w) for w in (1, 7, 33, 64)]:
        sel, nb = sel_of(cls)
        calls.append((f"KE1 {label} (width {w}, {nb} miniblocks)",
                      lambda sel=sel, nb=nb, w=w: pack_bits(
                          alo, ahi, w, 32 * nb, sel=sel),
                      lambda sel=sel, nb=nb, w=w: pack_bits_plain(
                          alo, ahi, w, 32 * nb, sel=sel)))
    for name, fn, plain in calls:
        err = _max_err(fn(), plain())
        if err:
            raise AssertionError(f"{name}: max abs diff {err} against the "
                                 "plain version")
        split = device_split(fn, tries=6)
        print(f"{name} split: device {_us(split)} a call, {split[1]:g} CUDA "
              f"launches ({split[2]}); max_abs_err 0", flush=True)
    pages = [("reading page", _t(cols["reading"], dev), 2, "float"),
             ("seq page", _t(cols["seq"], dev), 1, "signed")]
    for label, flat, lanes, order in pages:
        n = flat.numel() // lanes
        got, want = (lanes_min_max(flat, lanes, order),
                     lanes_min_max_plain(flat, lanes, order))
        if got != want:
            raise AssertionError(f"KE5 {label}: {got}, plain {want}")
        split = device_split(lambda: lanes_min_max(flat, lanes, order),
                             tries=6)
        print(f"KE5 {label} ({n} values of {lanes} lanes) split: device "
              f"{_us(split)} a call, {split[1]:g} CUDA operations "
              f"({split[2]}); max_abs_err 0", flush=True)


def k10_moved(nn: int, nb: int, cap: int, blob_size: int, pos: int,
              n_offs: int) -> int:
    """Device-memory bytes K10's design moves on a page, by its
    arithmetic (no counter is read): the records' bytes (values and
    length prefixes) and the tail's sources read once from the blob, each
    value's end once, the output written once.  The tiles' two searches
    read a few sectors of the offsets each, from L2, and are not
    counted."""
    from tpuparquet_torch.kernels.decode import blob_tile_bytes

    start = pos + nb + 4 * (n_offs - 1)  # the tail's first source byte
    tail = max(min(cap - nb, blob_size - start), 0)
    tail += 1 if start + cap - nb > blob_size else 0  # the clipped byte
    tiles = -(-cap // blob_tile_bytes())
    return nb + 4 * nn + tail + 4 * (nn + tiles) + cap


def ke4_moved(n: int, lanes: int, span: int) -> int:
    """Device-memory bytes KE4's design moves for ``n`` values over a
    range of ``span``, by its arithmetic: at or below the small range the
    values read twice (whole sectors of the lane words), the indices
    written once, the range table filled, claimed by each block of the
    first pass and read back by the ranking block and by each gather
    block, the order written; past it the flag scan: the values read
    three times (first, scan, gather), the range table read at each value
    twice (scan, gather), the n-word scan written and read, the indices
    written, the table filled, claimed and ranked."""
    from tpuparquet_torch.kernels.encode import dict_small_range

    if span <= dict_small_range():
        blocks = -(-n // 8192)
        return 8 * lanes * n + 4 * n + 4 * span * (2 * blocks + 3)
    return 12 * lanes * n + 20 * n + 16 * span


def dict_build_uniform(dev, n: int = 1_250_000, span: int = 1 << 16) -> None:
    """KE4 on ``n`` uniform random values over a range of ``span`` (no hot
    value; by default past the small range, the flag scan's path), held
    against its plain version; its device time and launches a call.
    Calls only ``encode.dict_build``, whose signature the parent shares,
    so the same function times the parent's kernel from its checkout."""
    from tpuparquet_torch.kernels.encode import dict_build, dict_build_plain

    g = torch.Generator(device=dev).manual_seed(31)
    flat = torch.randint(0, span, (n,), dtype=torch.int32, device=dev,
                         generator=g)
    flat[:2] = torch.tensor([0, span - 1], dtype=torch.int32, device=dev)
    got, want = (dict_build(flat, 1, n, 0, span),
                 dict_build_plain(flat, 1, n, 0, span))
    err = max(_max_err(got[0], want[0]), _max_err(got[2], want[2]),
              abs(got[1] - want[1]))
    if err:
        raise AssertionError(f"KE4 range {span}: max abs diff {err} against "
                             "the plain version")
    split = device_split(lambda: dict_build(flat, 1, n, 0, span))
    bound, _ = _bound_ms(8 * n + 4 * span, 0)
    print(f"KE4 {n} uniform values over a range of {span}: device "
          f"{_us(split)} a call, {split[1]:g} CUDA launches ({split[2]}); "
          f"bound {1e3 * bound:.1f} us; max_abs_err 0", flush=True)


def _device_groups(reader, dev) -> list:
    """Every row group read on the card, each column as its
    ``as_values()`` and each optional column's mask from the read:
    ``[(columns, masks)]``, as ``_write`` takes them."""
    from tpuparquet_torch.kernels.device import read_row_groups_device

    groups = []
    for _, cols in read_row_groups_device(reader, device=dev):
        groups.append((
            {name: col.as_values() for name, col in cols.items()},
            {name: col.mask.cpu().numpy() for name, col in cols.items()
             if reader.schema.leaf(name).max_def_level}))
    _sync(dev)
    return groups


def check_write(label, blob, schema, encodings, dv_groups, wrappers,
                want_pages: int) -> dict:
    """Phase 5: write the card-resident row groups back with the writer
    that made ``blob`` (SNAPPY, the file's encodings), the kernel counts
    set to 0 just before; the file must equal ``blob`` byte for byte and
    ``want_pages`` data pages must have encoded on the card.  Returns
    the launches."""
    from tpuparquet_torch.stats import collect_stats

    for fn in wrappers.values():
        fn.launches = 0
    with collect_stats() as st:
        out = _write(schema, dv_groups, None, column_encodings=encodings)
    launches = {k: fn.launches for k, fn in wrappers.items()}
    print(f"{label} write launches: {launches}; pages_device_encoded "
          f"{st.pages_device_encoded}", flush=True)
    if out != blob:
        at = next((i for i, (a, b) in enumerate(zip(out, blob)) if a != b),
                  min(len(out), len(blob)))
        raise AssertionError(f"{label}: the file written from DeviceValues "
                             f"differs from the original at byte {at} "
                             f"({len(out)} vs {len(blob)} bytes)")
    if st.pages_device_encoded != want_pages:
        raise AssertionError(f"{label}: {st.pages_device_encoded} pages "
                             f"encoded on the card, expected {want_pages}")
    print(f"{label}: the file written from DeviceValues equals the "
          f"original, {len(out)} bytes", flush=True)
    return launches


def _best_write(label, write, n_values, reps: int = 3) -> None:
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        write()
        best = min(best, time.perf_counter() - t0)
    print(f"{label} best of {reps}: {best:.4f} s, {n_values / best:.4e} "
          "values/s", flush=True)


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _set_transports(on: bool) -> None:
    for k in TRANSPORT_ENV:
        if on:
            os.environ.pop(k, None)  # the defaults: every transport on
        else:
            os.environ[k] = "0"


def _drive(reader, dev, wrappers):
    """Read every row group on the card, the kernel counts set to 0 just
    before; returns (outputs, launches, stats)."""
    from tpuparquet_torch.kernels.device import read_row_groups_device
    from tpuparquet_torch.stats import collect_stats

    for fn in wrappers.values():
        fn.launches = 0
    with collect_stats() as st:
        got = list(read_row_groups_device(reader, device=dev))
        _sync(dev)
    _no_ladder("a read", st)
    return got, {k: fn.launches for k, fn in wrappers.items()}, st


# the resilient ladder's counters, which no un-faulted path may move
LADDER = ("dispatch_retries", "units_degraded", "pages_degraded")
# the paths checked by _no_ladder in this run, read by phase 8c
LADDER_CHECKED: list = []


def _no_ladder(label, st) -> None:
    """``st`` (a collector or a ``to_state()`` dict) retried no dispatch
    and degraded no page or unit."""
    got = {k: (st[k] if isinstance(st, dict) else getattr(st, k))
           for k in LADDER}
    if any(got.values()):
        raise AssertionError(f"{label}: the resilient ladder moved on an "
                             f"un-faulted path: {got}")
    LADDER_CHECKED.append(label)


def _same_values(got, want) -> bool:
    """Strings by offsets and bytes, numbers bit for bit."""
    if hasattr(want, "offsets"):
        return (np.array_equal(got.offsets, want.offsets)
                and np.array_equal(got.data, want.data))
    want = np.ascontiguousarray(want)
    return got.dtype == want.dtype and np.array_equal(
        got.view(np.uint8), want.view(np.uint8))


def _check_read(label, reader, got, groups) -> int:
    """Every value, rep and def level and mask against the generator's
    ``[(columns, {optional column: mask})]`` (flat columns: all rep
    levels 0); row group 0 against the CPU run buffer for buffer.
    Returns the value count."""
    _check_values(label, got, groups)
    _same_as_cpu(label, reader, got)
    n_values = sum(cc.meta_data.num_values for rg in reader.meta.row_groups
                   for cc in rg.columns)
    print(f"{label}: {n_values} values match the generator; row group 0 "
          "matches the cpu run buffer for buffer", flush=True)
    return n_values


def _check_values(label, got, groups) -> None:
    """Every value, def level and mask of flat columns (rep levels all 0)
    against the generator's ``[(columns, {optional column: mask})]``, one
    entry a read row group."""
    if len(got) != len(groups):
        raise AssertionError(f"{label}: {len(got)} row groups read, "
                             f"expected {len(groups)}")
    for (rg, out), (cols, masks) in zip(got, groups):
        rows = next(iter(out.values())).num_values
        for name, col in out.items():
            vals, rep, dl = col.to_numpy()
            if not _same_values(vals, cols[name]):
                raise AssertionError(f"{label} row group {rg} {name}: "
                                     "values differ")
            mask = masks.get(name)
            want_dl = (np.zeros(rows, np.int32) if mask is None
                       else mask.astype(np.int32))
            if not np.array_equal(dl, want_dl):
                raise AssertionError(f"{label} row group {rg} {name}: "
                                     "def levels")
            want_mask = np.ones(rows, bool) if mask is None else mask
            if not np.array_equal(col.mask.cpu().numpy(), want_mask):
                raise AssertionError(f"{label} row group {rg} {name}: mask")
            if rep.any():
                raise AssertionError(f"{label} row group {rg} {name}: "
                                     "rep levels of a flat column")


def _want_list_levels(offs, row_mask, elem_mask):
    """Rep and def levels of config 3's ``optional group (LIST) {
    repeated group list { optional element } }`` (max def 3), worked out
    slot by slot from the generator: a row of ``c`` elements takes
    ``max(c, 1)`` slots; a null row's slot has def 0, an empty row's def
    1, a null element def 2, a value def 3."""
    counts = np.diff(offs)
    slots = np.maximum(counts, 1)
    row_of_slot = np.repeat(np.arange(counts.size), slots)
    first = np.zeros(slots.sum(), bool)
    first[np.cumsum(slots) - slots] = True
    rep = np.where(first, 0, 1).astype(np.int32)
    dl = np.empty(slots.sum(), np.int32)
    has = counts[row_of_slot] > 0
    dl[~has] = np.where(row_mask[row_of_slot[~has]], 1, 0)
    dl[has] = np.where(elem_mask, 3, 2)
    return rep, dl


def _check_list_read(label, reader, got, groups) -> int:
    """Config 3's read: every value, rep and def level and the mask
    against the generator's ``[(columns, masks, offsets,
    element_masks)]``; row group 0 against the CPU run buffer for buffer.
    Returns the level-slot count."""
    for (rg, out), (cols, masks, offs, elems) in zip(got, groups):
        col = out["events.list.element"]
        vals, rep, dl = col.to_numpy()
        want_rep, want_dl = _want_list_levels(offs["events"], masks["events"],
                                              elems["events"])
        if not _same_values(vals, cols["events"]):
            raise AssertionError(f"{label} row group {rg}: values differ")
        if not np.array_equal(rep, want_rep):
            raise AssertionError(f"{label} row group {rg}: rep levels")
        if not np.array_equal(dl, want_dl):
            raise AssertionError(f"{label} row group {rg}: def levels")
        if not np.array_equal(col.mask.cpu().numpy(), want_dl == 3):
            raise AssertionError(f"{label} row group {rg}: mask")
    _same_as_cpu(label, reader, got)
    n_slots = sum(cc.meta_data.num_values for rg in reader.meta.row_groups
                  for cc in rg.columns)
    print(f"{label}: {n_slots} level slots match the generator; row group "
          "0 matches the cpu run buffer for buffer", flush=True)
    return n_slots


def _same_as_cpu(label, reader, got) -> None:
    """Row group 0 read on the card against the CPU run, buffer for
    buffer (rep levels included)."""
    from tpuparquet_torch.kernels.device import read_row_group_device

    cpu = read_row_group_device(reader, 0, device="cpu")
    for name, col in got[0][1].items():
        a, b = col.padded_buffers(), cpu[name].padded_buffers()
        if a.keys() != b.keys() or not all(
                a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])
                for k in a):
            raise AssertionError(f"{label} row group 0 {name}: cuda and cpu "
                                 "buffers differ")


def _routing(label, st, want: dict) -> None:
    got = {k: getattr(st, k) for k in want}
    print(f"{label} routing: {got}", flush=True)
    if got != want:
        raise AssertionError(f"{label}: routing {got}, expected {want}")


def _plan_workers(threads) -> int:
    """The plan workers of a read at ``TPQ_PLAN_THREADS=threads`` (None:
    the default)."""
    from tpuparquet_torch.kernels.device import _plan_threads

    with _plan_threads_env(threads):
        return _plan_threads()


@contextlib.contextmanager
def _env(**kv):
    """The environment variables ``kv`` set (None: unset) inside the
    block, restored after."""
    prev = {k: os.environ.get(k) for k in kv}
    for k, v in kv.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = str(v)
    try:
        yield
    finally:
        for k, v in prev.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _plan_threads_env(threads):
    """``TPQ_PLAN_THREADS`` set to ``threads`` (None: unset) inside the
    block, restored after."""
    return _env(TPQ_PLAN_THREADS=threads)


def _best_one(label, reader, dev, n_values, reps: int = 3, note: str = "",
              threads=None) -> float:
    """Best of ``reps`` read passes at ``TPQ_PLAN_THREADS=threads``
    (None: the default), printed with the best pass's phases; returns its
    wall."""
    from tpuparquet_torch.kernels.device import read_row_groups_device
    from tpuparquet_torch.stats import collect_stats

    best, phases = float("inf"), None
    with _plan_threads_env(threads):
        for _ in range(reps):
            with collect_stats() as st:
                t0 = time.perf_counter()
                outs = [out for _, out in read_row_groups_device(
                    reader, device=dev)]
                _sync(dev)
                dt = time.perf_counter() - t0
            del outs
            if dt < best:
                best, phases = dt, st
    print(f"{label} at {_plan_workers(threads)} plan workers, best of "
          f"{reps}: {best:.4f} s, {n_values / best:.4e} values/s; plan_s "
          f"{phases.plan_s:.4f}, transfer_s {phases.transfer_s:.4f}, "
          f"dispatch_s {phases.dispatch_s:.4f}, bytes_staged "
          f"{phases.bytes_staged}{note}", flush=True)
    return best


def _best_of(label, reader, dev, n_values, reps: int = 3, note: str = ""):
    """Best of ``reps`` passes at the default worker count, then at one
    worker; returns the two walls."""
    walls = [_best_one(label, reader, dev, n_values, reps, note, threads)
             for threads in (None, 1)]
    print(f"{label} pass wall: {walls[0]:.4f} s at "
          f"{_plan_workers(None)} workers, {walls[1]:.4f} s at 1",
          flush=True)
    return walls


SAME_COUNTERS = ("bytes_staged", "pages_crc_verified",
                 "pages_device_snappy", "pages_device_delta_lanes",
                 "pages_device_planes")


def _same_columns(label, got, want) -> None:
    """Two reads' ``[(rg, {path: DeviceColumn})]``, every stored buffer
    (padding included) equal on the device."""
    if [rg for rg, _ in got] != [rg for rg, _ in want]:
        raise AssertionError(f"{label}: row groups differ")
    for (rg, a), (_, b) in zip(got, want):
        if a.keys() != b.keys():
            raise AssertionError(f"{label} row group {rg}: columns differ")
        for name, c in a.items():
            d = b[name]
            if (c.num_values, c.n_packed, c.n_bytes) != \
                    (d.num_values, d.n_packed, d.n_bytes):
                raise AssertionError(f"{label} row group {rg} {name}: "
                                     "lengths differ")
            for slot in ("_data_p", "offsets", "_mask_p", "_pos_p",
                         "_rep_p", "_def_p"):
                x, y = getattr(c, slot), getattr(d, slot)
                if (x is None) != (y is None) or (
                        x is not None and (x.dtype != y.dtype
                                           or not torch.equal(x, y))):
                    raise AssertionError(f"{label} row group {rg} {name}: "
                                         f"{slot} differs")


def _same_at_one_worker(label, reader, dev, wrappers, got, launches,
                        st) -> None:
    """The read again at ``TPQ_PLAN_THREADS=1``: buffers, the counters of
    SAME_COUNTERS and every kernel's launches equal the default's."""
    with _plan_threads_env(1):
        got1, launches1, st1 = _drive(reader, dev, wrappers)
    _same_columns(f"{label} at 1 plan worker", got1, got)
    want = {k: getattr(st, k) for k in SAME_COUNTERS}
    have = {k: getattr(st1, k) for k in SAME_COUNTERS}
    if have != want or launches1 != launches:
        raise AssertionError(
            f"{label}: at 1 plan worker counters {have} and launches "
            f"{launches1}, at {_plan_workers(None)} {want} and {launches}")
    print(f"{label}: at 1 and {_plan_workers(None)} plan workers the same "
          f"buffers, counters and launches", flush=True)


def _chunk_count(reader) -> int:
    return sum(len(rg.columns) for rg in reader.meta.row_groups)


def check_plan_cache(label, reader, dev, wrappers) -> None:
    """Two reads under ``TPQ_PLAN_CACHE_MB=64`` from an empty cache: the
    cold one misses once a chunk, the warm one hits once a chunk and
    misses none, with the cold one's routing and buffers; both walls
    printed."""
    from tpuparquet_torch.kernels.plancache import clear_plan_cache

    prev = os.environ.get("TPQ_PLAN_CACHE_MB")
    os.environ["TPQ_PLAN_CACHE_MB"] = "64"
    clear_plan_cache()
    try:
        passes = []
        for _ in range(2):
            t0 = time.perf_counter()
            got, launches, st = _drive(reader, dev, wrappers)
            passes.append((time.perf_counter() - t0, got, launches, st))
    finally:
        if prev is None:
            os.environ.pop("TPQ_PLAN_CACHE_MB", None)
        else:
            os.environ["TPQ_PLAN_CACHE_MB"] = prev
        clear_plan_cache()
    (cold_s, cold, cold_l, cold_st), (warm_s, warm, warm_l, warm_st) = passes
    n = _chunk_count(reader)
    got = [(p.plan_cache_hits, p.plan_cache_misses)
           for p in (cold_st, warm_st)]
    if got != [(0, n), (n, 0)]:
        raise AssertionError(f"{label}: plan cache (hits, misses) cold and "
                             f"warm {got}, expected {[(0, n), (n, 0)]}")
    want = {k: getattr(cold_st, k) for k in SAME_COUNTERS}
    have = {k: getattr(warm_st, k) for k in SAME_COUNTERS}
    if have != want or warm_l != cold_l:
        raise AssertionError(f"{label}: the warm pass's counters {have} "
                             f"and launches {warm_l}, the cold pass's "
                             f"{want} and {cold_l}")
    _same_columns(f"{label} warm plan cache", warm, cold)
    print(f"{label} plan cache: cold pass {cold_s:.4f} s (plan_s "
          f"{cold_st.plan_s:.4f}), warm pass {warm_s:.4f} s (plan_s "
          f"{warm_st.plan_s:.4f}); {n} hits of {n} chunks, the cold "
          "pass's routing and buffers", flush=True)


def check_range_reads(label, path, got, dev, wrappers) -> None:
    """Config 2 from its file path: every chunk read as a range of the
    open file, ``bytes_read`` the chunks' compressed bytes, the buffers
    the in-memory read's (``got``)."""
    from tpuparquet_torch.io.reader import FileReader

    with FileReader(path) as reader:
        t0 = time.perf_counter()
        from_path, _, st = _drive(reader, dev, wrappers)
        wall = time.perf_counter() - t0
        want = sum(cc.meta_data.total_compressed_size
                   for rg in reader.meta.row_groups for cc in rg.columns)
    if st.bytes_read != want:
        raise AssertionError(f"{label}: bytes_read {st.bytes_read}, the "
                             f"chunks hold {want}")
    _same_columns(f"{label} from its path", from_path, got)
    print(f"{label} from its path: {wall:.4f} s, bytes_read "
          f"{st.bytes_read} in read_s {st.read_s:.4f}; the in-memory "
          "read's buffers", flush=True)


def sweep_workers(label, reader, dev, n_values) -> None:
    """Best of 3 at 2, 4 and the usable CPU count of plan workers, less
    the counts :func:`_best_of` timed already (1 and the default)."""
    done = {1, _plan_workers(None)}
    for threads in sorted({2, 4, len(os.sched_getaffinity(0))} - done):
        _best_one(f"{label} sweep", reader, dev, n_values, threads=threads)


def _launches_by_column(reader, dev, wrappers) -> dict:
    """Row group 0 again, each column finished on its own, the counts set
    to 0 before each: ``{column: {kernel: launches}}`` (kernels that
    launched)."""
    from tpuparquet_torch.kernels.device import _finish_row_group, \
        _plan_row_group

    out = {}
    for item in _plan_row_group(reader, 0):
        for fn in wrappers.values():
            fn.launches = 0
        _finish_row_group([item], dev)
        out[item[0]] = {k: fn.launches for k, fn in wrappers.items()
                        if fn.launches}
    return out


def _need(label, launches, names) -> None:
    missing = [k for k in names if launches[k] == 0]
    if missing:
        raise AssertionError(f"{label} launched no {missing}")


def _need_any(label, launches, names) -> None:
    if not any(launches[k] for k in names):
        raise AssertionError(f"{label} launched none of {names}")


# ----------------------------------------------------------------------
# Phases 3i and 5b: the GZIP, ZSTD and LZ4_RAW codecs
# ----------------------------------------------------------------------

# config 2's kernels: the dictionary columns (K1-K3), the optional
# column's validity (K4), pickup_ts's delta lanes (K7 after K1) and
# trip_distance_mm's byte planes (K5)
CONFIG2_KERNELS = ["unpack_u32", "expand_hybrid", "page_dict_fixed",
                   "levels_to_validity", "planes_to_words", "delta_scan"]
# phase 5b's split page: one PLAIN int64 page of 64 MiB, 64 blocks of the
# default TPQ_COMPRESS_BLOCK_KB (1 MiB)
SPLIT_VALUES = 8_388_608
SPLIT_SCHEMA = "message split { required int64 v; }"


def codec_backends() -> dict:
    """Print, on one line, the codec backends this host gives the port:
    where libz and libzstd were loaded from (None: not loaded), the
    ``zstandard`` wheel's version (None: not installed) and whether
    ``csrc/lz4raw.c`` built.  Raises when a codec has no backend (ZSTD
    needs libzstd or the wheel, LZ4_RAW the C compiler; GZIP always has
    the stdlib ``zlib`` module)."""
    from tpuparquet_torch import compress, syslibs

    got = {"libz": syslibs.library_path(syslibs.zlib_native()),
           "libzstd": syslibs.library_path(syslibs.zstd_native())}
    try:
        import zstandard

        got["zstandard"] = zstandard.__version__
    except ImportError:
        got["zstandard"] = None
    try:
        compress._lz4()
        got["lz4raw.c"] = "built"
    except RuntimeError as e:
        got["lz4raw.c"] = f"not built ({e})"
    print(f"codec backends: libz {got['libz']}, libzstd {got['libzstd']}, "
          f"zstandard wheel {got['zstandard']}, csrc/lz4raw.c "
          f"{got['lz4raw.c']}", flush=True)
    if got["libzstd"] is None and got["zstandard"] is None:
        raise AssertionError("ZSTD has no backend: no libzstd loads and "
                             "the zstandard wheel is not installed")
    if got["lz4raw.c"] != "built":
        raise AssertionError("LZ4_RAW has no backend: csrc/lz4raw.c "
                             "did not build")
    return got


ROUTING = ("pages_device_delta_lanes", "pages_device_planes",
           "pages_device_snappy")


def check_codec_read(label, blob, groups, dev, wrappers, snappy_size: int,
                     snappy_read) -> dict:
    """Phase 3i: a config-2 file of another codec read on the card:
    every value, level and mask against the generator, row group 0
    against the CPU run, the read again at one plan worker (the same
    buffers, counters and launches), and the routing and launches of
    ``snappy_read`` (``(launches, stats)`` of the SNAPPY file of the same
    values read on the card: the transports compete on the decompressed
    values of every codec, and no page takes the snappy tokens); best of
    3 at both worker counts.  Returns the launches."""
    from tpuparquet_torch.io.reader import FileReader

    reader = FileReader(blob)
    got, launches, st = _drive(reader, dev, wrappers)
    print(f"{label} launches: {launches}", flush=True)
    n = _check_read(label, reader, got,
                    [(c, {"payment_type": m}) for c, m in groups])
    _same_at_one_worker(label, reader, dev, wrappers, got, launches, st)
    del got
    want_launches, snappy_st = snappy_read
    _routing(label, st, {k: getattr(snappy_st, k) for k in ROUTING})
    if st.pages_device_snappy or not (st.pages_device_delta_lanes
                                      or st.pages_device_planes):
        raise AssertionError(f"{label}: a page took the snappy tokens, or "
                             "none took a transport")
    _need(label, launches, CONFIG2_KERNELS)
    if launches != want_launches:
        raise AssertionError(f"{label}: launches {launches}, the SNAPPY "
                             f"file's {want_launches}")
    print(f"{label}: {len(blob)} bytes (the SNAPPY file of the same values "
          f"{snappy_size}); the SNAPPY file's launches and routing",
          flush=True)
    _best_of(label, reader, dev, n)
    return launches


def codec_reads(groups, blob, snappy_read, dev, wrappers,
                values_small: int):
    """Phase 3i: config 2 written by the port's writer in ZSTD (phase
    3's ``groups``: the SNAPPY file ``blob`` and its transports read,
    ``snappy_read``, are the yardstick), and in GZIP and LZ4_RAW at
    ``values_small`` values in 2 row groups (beside a SNAPPY file of the
    same values, read once for its launches and routing and timed as
    they are).  Returns
    ``(ZSTD file, {label: launches})``."""
    from tpuparquet_torch.io.reader import FileReader

    out = {}
    t0 = time.perf_counter()
    blob_z = _write(SCHEMA, groups, "payment_type", codec="ZSTD")
    print(f"config 2 ZSTD: {len(groups)} row groups, {len(blob_z)} bytes, "
          f"written in {time.perf_counter() - t0:.2f} s", flush=True)
    out["3i config 2 ZSTD"] = check_codec_read(
        "3i config 2 ZSTD", blob_z, groups, dev, wrappers, len(blob),
        snappy_read)
    small = config2_groups(values_small, 2)
    snappy = _write(SCHEMA, small, "payment_type")
    snappy_reader = FileReader(snappy)
    _, small_launches, small_st = _drive(snappy_reader, dev, wrappers)
    _best_of("3i config 2 SNAPPY (the yardstick of GZIP and LZ4_RAW)",
             snappy_reader, dev, sum(cc.meta_data.num_values for rg in
                                     snappy_reader.meta.row_groups
                                     for cc in rg.columns))
    for codec in ("GZIP", "LZ4_RAW"):
        label = f"3i config 2 {codec}"
        t0 = time.perf_counter()
        cblob = _write(SCHEMA, small, "payment_type", codec=codec)
        print(f"config 2 {codec}: 2 row groups, {len(cblob)} bytes, "
              f"written in {time.perf_counter() - t0:.2f} s", flush=True)
        out[label] = check_codec_read(label, cblob, small, dev, wrappers,
                                      len(snappy), (small_launches, small_st))
    return blob_z, out


def codec_writes(groups, blob_z, dev, wrappers, n_values) -> dict:
    """Phase 5b: config 2 in ZSTD from numpy at ``encode_threads=1``
    equals the file of the default workers (``blob_z``, phase 3i), both
    timed best of 3; then a one-column PLAIN int64 file of one 64 MiB
    page in ZSTD and in GZIP at the default workers, with
    ``TPQ_COMPRESS_BLOCK_KB`` unset: the page must split into 64 blocks,
    and read back on the card the values must equal the generator and a
    ZSTD body decode its 64 frames one a worker.  Returns the reads'
    launches."""
    from tpuparquet_torch.io.reader import FileReader
    from tpuparquet_torch.io.writer import _write_threads
    from tpuparquet_torch.stats import collect_stats

    workers = _write_threads()
    one = _write(SCHEMA, groups, "payment_type", codec="ZSTD",
                 encode_threads=1)
    if one != blob_z:
        raise AssertionError("5b config 2 ZSTD: the file of 1 encode worker "
                             f"differs from the file of {workers}")
    print(f"5b config 2 ZSTD: the files of 1 and {workers} encode workers "
          f"are equal, {len(one)} bytes", flush=True)
    del one
    for threads in (1, None):
        n_w = threads or workers
        _best_write(f"5b config 2 ZSTD write from numpy at {n_w} encode "
                    f"worker{'s' if n_w > 1 else ''}",
                    lambda t=threads: _write(SCHEMA, groups, "payment_type",
                                             codec="ZSTD", encode_threads=t),
                    n_values)
    if workers < 2:
        raise AssertionError("5b: the default encode workers are 1, so no "
                             "page body splits")
    prev = os.environ.pop("TPQ_COMPRESS_BLOCK_KB", None)
    launches = dict.fromkeys(wrappers, 0)
    try:
        v = np.random.default_rng(53).integers(
            -(1 << 20), 1 << 20, SPLIT_VALUES).cumsum()
        for codec in ("ZSTD", "GZIP"):
            label = f"5b split page {codec}"
            with collect_stats() as st:
                t0 = time.perf_counter()
                blob = _write(SPLIT_SCHEMA, [({"v": v}, None)], None,
                              codec=codec, allow_dict=False)
                dt = time.perf_counter() - t0
            print(f"{label}: {v.nbytes} bytes of values in {len(blob)} "
                  f"bytes, written in {dt:.4f} s at {workers} workers; "
                  f"codec_split_blocks {st.codec_split_blocks}", flush=True)
            if st.codec_split_blocks != 64:
                raise AssertionError(f"{label}: {st.codec_split_blocks} "
                                     "blocks, expected 64")
            got, got_launches, rst = _drive(FileReader(blob), dev, wrappers)
            vals = got[0][1]["v"].to_numpy()[0]
            if not _same_values(vals, v):
                raise AssertionError(f"{label}: the values read on the card "
                                     "differ from the generator")
            frames = 64 if codec == "ZSTD" else 0  # gzip members: one loop
            print(f"{label} read on the card: values match; "
                  f"codec_split_frames {rst.codec_split_frames}, plan_s "
                  f"{rst.plan_s:.4f}, routing delta lanes "
                  f"{rst.pages_device_delta_lanes}, planes "
                  f"{rst.pages_device_planes}", flush=True)
            if rst.codec_split_frames != frames:
                raise AssertionError(f"{label}: {rst.codec_split_frames} "
                                     f"frames decoded, expected {frames}")
            for k, c in got_launches.items():
                launches[k] += c
            del got
    finally:
        if prev is not None:
            os.environ["TPQ_COMPRESS_BLOCK_KB"] = prev
    return launches


# ----------------------------------------------------------------------
# Phase 6: the sharded scan
# ----------------------------------------------------------------------

def shard_meshes(dev) -> list:
    """Phase 6's meshes: the default mesh (1x1: the one card) and a 2x2
    mesh of four slots on the same device."""
    from tpuparquet_torch.shard import make_mesh

    one = make_mesh() if dev.type == "cuda" else make_mesh(devices=[dev])
    if one.shape != {"rg": 1, "sp": 1} or one.devices[0, 0] != dev:
        raise AssertionError(f"the default mesh is {one}, expected 1x1 on "
                             f"{dev}")
    return [("1x1", one), ("2x2", make_mesh(4, devices=[dev] * 4))]


def _dense_fixed(values, mask, lanes: int) -> np.ndarray:
    """Generator values as the gather's rows: null slots 0, u32 lanes."""
    values = np.ascontiguousarray(values)
    if mask is not None:
        dense = np.zeros(mask.size, dtype=values.dtype)
        dense[mask] = values
        values = dense
    return values.view(np.uint32).reshape(-1, lanes)


def _dense_bytes(col, mask):
    """``(offsets int32, bytes)`` of a generator string column with its
    null slots as empty values."""
    lens = np.diff(col.offsets)
    if mask is not None:
        dl = np.zeros(mask.size, np.int64)
        dl[mask] = lens
        lens = dl
    offs = np.zeros(lens.size + 1, np.int64)
    np.cumsum(lens, out=offs[1:])
    return offs.astype(np.int32), np.asarray(col.data)


def _check_fixed_gather(label, name, got, groups, results) -> None:
    """A replicated gather_column against the generator and each unit's
    own DeviceColumn: the unit's slots, then zeros."""
    vals, counts = got
    lanes = vals.shape[2]
    for u, (cols, masks) in enumerate(groups):
        want = _dense_fixed(cols[name], masks.get(name), lanes)
        n = want.shape[0]
        col = results[u][name]
        own = _dense_fixed(col.to_numpy()[0], col.mask.cpu().numpy(), lanes)
        if counts[u] != n or not np.array_equal(vals[u, :n], want) \
                or not np.array_equal(own, want) or vals[u, n:].any():
            raise AssertionError(f"{label} {name}: unit {u} differs from "
                                 "the generator")


def _check_bytes_gather(label, name, got, groups) -> None:
    """A replicated gather_byte_column against the generator: every row's
    offsets and bytes, then the edge padding and the zero bytes."""
    offs, data, rows, nbytes = got
    for u, (cols, masks) in enumerate(groups):
        want_o, want_d = _dense_bytes(cols[name], masks.get(name))
        n, nb = want_o.size - 1, want_d.size
        if rows[u] != n or nbytes[u] != nb \
                or not np.array_equal(offs[u, : n + 1], want_o) \
                or (offs[u, n + 1:] != want_o[-1]).any() \
                or not np.array_equal(data[u, :nb], want_d) \
                or data[u, nb:].any():
            raise AssertionError(f"{label} {name}: unit {u} differs from "
                                 "the generator")


def _as_host(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else x


def _same_gather(label, name, placed, rep, where: str) -> None:
    """A placed gather equals the replicated one, array by array (the
    placed values are int32 tensors holding the u32 bits)."""
    for a, b in zip(placed, rep):
        a = _as_host(a)
        if a.dtype == np.int32 and b.dtype == np.uint32:
            a = a.view(np.uint32)
        if a.shape != b.shape or not np.array_equal(a, b):
            raise AssertionError(f"{label} {name}: the gather {where} "
                                 "differs from the replicated gather")


def _best_gather(label, fn, reps: int = 3) -> None:
    """Best of ``reps`` host-clock times of ``fn`` (which ends in a
    synchronize), with the best pass's ``gather_reshard_s``."""
    from tpuparquet_torch.stats import collect_stats

    best, reshard = float("inf"), None
    for _ in range(reps):
        with collect_stats() as st:
            t0 = time.perf_counter()
            fn()
            dt = time.perf_counter() - t0
        if dt < best:
            best, reshard = dt, st.gather_reshard_s
    print(f"{label} best of {reps}: {best:.4f} s, gather_reshard_s "
          f"{reshard:.6f}", flush=True)


def _best_run(label, fn, reps: int = 3) -> float:
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    print(f"{label} best of {reps}: {best:.4f} s", flush=True)
    return best


def check_sharded_scan(label, mesh, blob, groups, fixed, byte_cols, dev,
                       wrappers, n_values) -> dict:
    """Phases 6a-6c: ``ShardedScan`` over one file on ``mesh``, ``run()``,
    then each column gathered replicated and to device 0 (KS1 or KS3,
    KS4), the counts set to 0 just before; each unit checked against the
    generator.  Then ``run()`` and each gather timed, best of 3.  Returns
    ``{"out", "moved", "launches", "results", "run_s"}`` (``run_s``: the
    best ``run()``)."""
    from tpuparquet_torch.shard import ShardedScan
    from tpuparquet_torch.stats import collect_stats

    target = 0 if dev.type == "cuda" else dev
    for fn in wrappers.values():
        fn.launches = 0
    scan = ShardedScan([blob], mesh=mesh)
    results = scan.run()
    out, moved = {}, {}
    for name in fixed + byte_cols:
        gather = (scan.gather_byte_column if name in byte_cols
                  else scan.gather_column)
        with collect_stats() as st:
            rep = gather(results, name)
        placed = gather(results, name, gather_to=target)
        with collect_stats() as sink_st:
            sink = gather(results, name, gather_to="cpu")
        _sync(dev)
        if name in byte_cols:
            _check_bytes_gather(label, name, rep, groups)
        else:
            _check_fixed_gather(label, name, rep, groups, results)
        _same_gather(label, name, placed, rep, "to device 0")
        _same_gather(label, name, sink, rep, "to the host")
        _same_gather(label, name, sink, [_as_host(a) for a in placed],
                     "to the host (against device 0)")
        n_arrays = 2 if name in byte_cols else 1
        if sink_st.gather_bytes_moved != sum(
                a.numel() * a.element_size() for a in sink[:n_arrays]):
            raise AssertionError(f"{label} {name}: the gather to the host "
                                 f"moved {sink_st.gather_bytes_moved} "
                                 "bytes, not its arrays' size")
        out[name], moved[name] = rep, st.gather_bytes_moved
    launches = {k: fn.launches for k, fn in wrappers.items()}
    print(f"{label} launches: {launches}; gather_bytes_moved (replicated) "
          f"{moved}", flush=True)
    print(f"{label}: {len(results)} units on {mesh}; every gathered unit "
          "matches the generator, replicated, on device 0 and on the host",
          flush=True)

    def run():
        with collect_stats() as st:
            scan.run()
            _sync(dev)
        _no_ladder(label, st)

    run_s = _best_run(f"{label} run() ({n_values} values)", run)
    for name in fixed + byte_cols:
        gather = (scan.gather_byte_column if name in byte_cols
                  else scan.gather_column)

        def placed():
            gather(results, name, gather_to=target)
            _sync(dev)

        def to_host():
            gather(results, name, gather_to="cpu")
            _sync(dev)

        _best_gather(f"{label} gather {name} replicated",
                     lambda: gather(results, name))
        _best_gather(f"{label} gather {name} to device 0", placed)
        _best_gather(f"{label} gather {name} to the host", to_host)
    scan.close()
    return {"out": out, "moved": moved, "launches": launches,
            "results": results, "run_s": run_s}


def _same_as_first(label, got, first) -> None:
    """6c: every gathered array of the 2x2 mesh equals the 1x1 mesh's, bit
    for bit, and the replicated gathers moved 4 times the bytes (once a
    slot; the assembly pads the units to a multiple of the slots, so with
    8 units both meshes assemble 8 rows)."""
    n = len(first["results"])
    ratio = 4 * max(-(-n // 4) * 4, 4) / n
    for name, rep in got["out"].items():
        for a, b in zip(rep, first["out"][name]):
            if a.dtype != b.dtype or not np.array_equal(a, b):
                raise AssertionError(f"{label} {name}: the 2x2 gather "
                                     "differs from the 1x1 gather")
        if got["moved"][name] != ratio * first["moved"][name]:
            raise AssertionError(
                f"{label} {name}: gather_bytes_moved {got['moved'][name]}, "
                f"expected {ratio} x {first['moved'][name]}")
    print(f"{label}: every gathered array equals the 1x1 mesh's bit for "
          f"bit; the replicated gathers moved {ratio}x the bytes",
          flush=True)


def dict_index_streams(reader) -> dict:
    """The dictionary-index streams of every dictionary-encoded column, as
    the file holds them (one a data page, here one a chunk), with their
    value counts: ``{column: (streams, counts, width, dictionary)}``.
    Each chunk's dictionary, ``(D, lanes)`` u32, stands as lane group k of
    one ``(D_max, chunks * lanes)`` dictionary, so lane group k of unit k
    decodes chunk k."""
    from tpuparquet_torch.compress import decompress_block
    from tpuparquet_torch.cpu.plain import decode_plain
    from tpuparquet_torch.format.compact import CompactReader
    from tpuparquet_torch.format.metadata import PageHeader, PageType, \
        Type, decode_struct
    from tpuparquet_torch.io.pages import scan_levels_v1
    from tpuparquet_torch.kernels.hybrid import count_eq_scan

    out = {}
    for path, node, _ in reader.selected_chunks(reader.meta.row_groups[0]):
        streams, counts, dicts, widths = [], [], [], set()
        for rg in reader.meta.row_groups:
            cm = next(c for p, _, c in reader.selected_chunks(rg)
                      if p == path)
            if cm.dictionary_page_offset is None:
                break
            blob, _ = reader.chunk_blob(cm, path)
            r = CompactReader(blob, 0, len(blob))
            while r.pos < len(blob):
                ph = decode_struct(PageHeader, r)
                raw = decompress_block(cm.codec, np.frombuffer(
                    blob[r.pos : r.pos + ph.compressed_page_size], np.uint8),
                    ph.uncompressed_page_size)
                r.pos += ph.compressed_page_size
                if PageType(ph.type) == PageType.DICTIONARY_PAGE:
                    vals = decode_plain(Type(cm.type), raw,
                                        ph.dictionary_page_header.num_values)
                    dicts.append(np.ascontiguousarray(vals).view(
                        np.uint32).reshape(vals.shape[0], -1))
                    continue
                n = ph.data_page_header.num_values
                dl, _, pos = scan_levels_v1(raw, n, node.max_def_level, 0)
                width = max(node.max_def_level.bit_length(), 1)
                non_null = n if dl is None else count_eq_scan(
                    dl, width, node.max_def_level)
                widths.add(int(raw[pos]))
                streams.append(bytes(raw[pos + 1:]))
                counts.append(non_null)
        if not streams:
            continue
        if len(widths) != 1 or len(dicts) != len(streams):
            raise AssertionError(f"{path}: {len(dicts)} dictionaries, "
                                 f"{len(streams)} pages, widths {widths}")
        width = widths.pop()
        lanes = dicts[0].shape[1]
        d_max = max(d.shape[0] for d in dicts)
        stacked = np.zeros((d_max, lanes * len(dicts)), np.uint32)
        for k, d in enumerate(dicts):
            stacked[: d.shape[0], k * lanes : (k + 1) * lanes] = d
        out[path] = (streams, counts, width, stacked)
    return out


def check_dict_decode(label, mesh, streams_by_col, results,
                      wrappers) -> dict:
    """Phase 6d: ``sharded_dict_decode`` of each column's streams on
    ``mesh`` (KS2, one launch a slot), the counts set to 0 just before;
    lane group k of unit k must equal the values of row group k's read
    (``results``, one unit a row group).  Returns the launches."""
    from tpuparquet_torch.shard import sharded_dict_decode

    for fn in wrappers.values():
        fn.launches = 0
    t0 = time.perf_counter()
    for path, (streams, counts, width, dictionary) in \
            streams_by_col.items():
        got = sharded_dict_decode(mesh, streams, counts, width, dictionary)
        lanes = dictionary.shape[1] // len(streams)
        for k in range(len(streams)):
            want = np.ascontiguousarray(results[k][path].to_numpy()[0]) \
                .view(np.uint32).reshape(-1, lanes)
            if not np.array_equal(got[k][:, k * lanes : (k + 1) * lanes],
                                  want):
                raise AssertionError(f"{label} {path}: unit {k} differs "
                                     "from the chunk's values")
    dt = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in wrappers.items()}
    print(f"{label}: {sum(len(v[0]) for v in streams_by_col.values())} "
          f"streams of {list(streams_by_col)} decoded on {mesh} in "
          f"{dt:.4f} s (planning, the copies and the checks included) "
          f"equal the chunks' values; launches {launches}", flush=True)
    return launches


def _step_at_tile(tile, bw, run_ends, run_is_rle, run_value, run_bp_start,
                  dictionary, out, unit0, pos0, n_pos, width, n_bp):
    """KS2 launched at a tile of ``tile`` positions (its wrapper takes
    ``gather.spmd_tile_positions()``), to time the tile sizes; it counts
    no launch."""
    from tpuparquet_torch.kernels._lib import launch, stream_of

    u, R = run_ends.shape
    launch("spmd_step", bw.data_ptr(), bw.shape[1], run_ends.data_ptr(),
           run_is_rle.data_ptr(), run_value.data_ptr(),
           run_bp_start.data_ptr(), R, dictionary.data_ptr(),
           dictionary.shape[0], dictionary.shape[1], u, pos0, n_pos, tile,
           max(width, 1), n_bp, out.data_ptr(), out.shape[1], unit0,
           stream_of(out))


def ks2_call(streams_by_col, dev):
    """KS2 at phase 4's shape, the first dictionary column's 6d batch on
    the one slot of the 1x1 mesh (every unit, every position), printed as
    the "KS2 shape" line: ``(call, in_bytes, out_bytes, moved)``, where
    ``call(fn)`` runs a KS2 function (the wrapper or its plain version)
    into a fresh output and ``moved`` is the device-memory bytes the
    design moves by its arithmetic: the output written once, the packed
    words, the run tables (13 bytes a run) and the dictionary read once,
    beside the L2 reads of each tile's runs and the staged
    dictionary."""
    from tpuparquet_torch.kernels.hybrid import plan_hybrid
    from tpuparquet_torch.shard.mesh import stack_hybrid_plans

    path, (streams, counts, width, dictionary) = next(iter(
        streams_by_col.items()))
    plans = [plan_hybrid(st, c, width) for st, c in zip(streams, counts)]
    batch = stack_hybrid_plans(plans)
    arrays, d = _step_inputs(batch, dictionary, dev)
    U, R = batch.run_ends.shape
    cnt, (D, lanes) = batch.count, dictionary.shape

    def call(fn):
        o = torch.empty((U, cnt, lanes), dtype=torch.int32, device=dev)
        fn(*arrays, d, o, 0, 0, cnt, width, batch.n_bp)
        return o

    in_bytes = sum(a.numel() * a.element_size() for a in arrays) + 4 * D \
        * lanes
    out_bytes = 4 * U * cnt * lanes
    moved = out_bytes + in_bytes
    print(f"KS2 shape: {path}, {U} units of {cnt} positions, width "
          f"{width}, {lanes} lanes, R {R} runs a unit, D {D} entries",
          flush=True)
    return call, in_bytes, out_bytes, moved


def ks3_call(col, dev):
    """KS3 at phase 4's shape, one BYTE_ARRAY unit ``col`` (a
    DeviceColumn) into rows of its own length, printed as the "KS3 shape"
    line: ``(call, n_bytes, library)``, where ``call(fn)`` runs a KS3
    function into fresh rows, ``n_bytes`` is the function's count (each
    input read once, each output written once) and ``library`` the one
    PyTorch call that computes its core, the running sum of the slot
    lengths."""
    offs, data = col.offsets[: col.n_packed + 1], col.data
    m, p = col.mask, col.positions
    n, nn, nb = col.num_values, col.n_packed, col.n_bytes
    L, B = n + 1, nb

    def call(fn):
        o = torch.empty(L, dtype=torch.int32, device=dev)
        b = torch.empty(B, dtype=torch.uint8, device=dev)
        fn(offs, nn, m, p, data, o, b)
        return o, b

    lens = torch.diff(offs)
    dl = torch.where(m, lens[p.long()], torch.zeros_like(lens[:1]))
    n_bytes = 4 * (nn + 1) + n + 4 * n + nb + 4 * L + B
    print(f"KS3 shape: note unit 0, n {n} slots, n_packed {nn}, nb {nb} "
          f"bytes, null share {1 - nn / n:.4f}", flush=True)
    return call, n_bytes, lambda: torch.cumsum(dl, 0, dtype=torch.int32)


def ks3_moved(L: int, B: int, n_bytes: int) -> int:
    """Device-memory bytes KS3's design moves for rows of L offsets and B
    bytes, by its arithmetic: the function's count ``n_bytes``, an
    aligned 16-byte vector more at each end of a block's share of the
    data, the memset of the ticket and the tiles' status words, and each
    status word written twice and read by about 32 successors'
    look-back."""
    from tpuparquet_torch.kernels.gather import densify_tile_slots

    tiles = -(-(L + 3) // densify_tile_slots())
    blocks = max(tiles, -(-B // 65536))
    return n_bytes + 32 * blocks + 16 + 8 * tiles * (1 + 2 + 32)


# ----------------------------------------------------------------------
# Phase 7: the multi-process scan
# ----------------------------------------------------------------------

# the kernels of config 2's path, which every process of phase 7 launches
MULTIHOST_KERNELS = ["unpack_u32", "expand_hybrid", "page_dict_fixed",
                     "levels_to_validity", "planes_to_words", "delta_scan"]


def unit_checksum(cols) -> int:
    """A checksum of one unit's columns, computed on their device: each
    column's packed words (or bytes) weighted by their index mod 997, in
    16-bit halves so that no int64 sum can overflow, plus its def
    levels."""
    total = 0
    for path in sorted(cols):
        c = cols[path]
        w = c.data.to(torch.int64)
        if c.data.dtype == torch.int32:
            w &= 0xFFFFFFFF
        idx = torch.arange(w.numel(), dtype=torch.int64,
                           device=w.device) % 997 + 1
        total += int(((w & 0xFFFF) * idx + (w >> 16) * (idx + 997))
                     .sum().item())
        total += int(c.def_levels.to(torch.int64).sum().item())
    return total


def _slowest_run(scan, threads, dev, reps: int = 3) -> float:
    """Best of ``reps`` of the slowest process's ``scan.run()`` wall at
    ``TPQ_PLAN_THREADS=threads``: both processes start each pass
    together, then all-gather their walls."""
    from tpuparquet_torch.shard import allgather_bytes, allgather_host

    best = float("inf")
    with _plan_threads_env(threads):
        for _ in range(reps):
            allgather_bytes(b"")  # a barrier
            t0 = time.perf_counter()
            scan.run()
            _sync(dev)
            wall = time.perf_counter() - t0
            best = min(best, float(allgather_host(np.float64(wall)).max()))
    return best


def _multihost_scan(path: str, ckpt: str, dev) -> dict:
    """7a, 7c and 7b's stopped run in one process of the pair."""
    from tpuparquet_torch.kernels.device import _usable_cpus
    from tpuparquet_torch.shard import MultiHostScan, allgather_host, \
        make_mesh

    from tpuparquet_torch.obs import attribution, digest, profiler
    from tpuparquet_torch.shard import allgather_digests, \
        allgather_ledgers, allgather_profiles

    mesh = make_mesh() if dev.type == "cuda" else make_mesh(devices=[dev])
    wrappers = kernel_wrappers()
    scan = MultiHostScan([path], mesh=mesh)
    for fn in wrappers.values():
        fn.launches = 0
    digest.set_digests(True)
    prof = profiler.set_profiling(True, hz=200.0)
    results, fleet, local = scan.run_with_stats()
    _sync(dev)
    profiler.set_profiling(False)
    launches = {k: fn.launches for k, fn in wrappers.items()}
    # the fleet folds of A.11 part 2, beside this process's own states
    states = {"digests": digest.digests().to_state(),
              "profile": prof.to_state(),
              "ledgers": attribution.ledgers_state()}
    folds = {"digests": allgather_digests().to_state(),
             "profile": allgather_profiles(states["profile"]),
             "ledgers": {k: v.to_state()
                         for k, v in allgather_ledgers().items()}}
    digest.set_digests(False)
    sums = np.zeros(len(scan.global_units), dtype=np.int64)
    for unit, out in zip(scan.local_units, results):
        sums[scan.global_units.index(unit)] = unit_checksum(out)
    del results
    got = {"mesh": [str(d) for d in scan.devices],
           "local_units": scan.local_units, "launches": launches,
           "checksums": allgather_host(sums).sum(axis=0).tolist(),
           "counts": scan.counts_allgather().tolist(),
           "fleet": fleet.to_state(), "local": local.to_state(),
           "states": states, "folds": folds}
    got["walls"] = [(_plan_workers(t), _slowest_run(scan, t, dev))
                    for t in (None, max(_usable_cpus() // 2, 1))]
    stop = MultiHostScan([path], mesh=mesh, resume_from=ckpt,
                         checkpoint_every=1)
    taken = []
    for k, _ in stop.run_iter():
        taken.append(stop.local_units[k])
        stop.request_stop()
    got["taken"], got["stopped"] = taken, stop.stopped
    return got


def multihost_child(argv) -> int:
    """One process of phase 7 (``chip_smoke.py --multihost-child PORT RANK
    OUT PATH TMP MODE DEVICE``): joins the gloo group of two at
    ``localhost:PORT`` as process RANK and scans the file PATH on a mesh
    of DEVICE (``cuda``: this process's card, the default mesh).  MODE
    ``scan`` runs 7a, 7c and 7b's stopped run, ``resume`` 7b's resumed
    run, both checkpointing to ``TMP/ckpt``; the findings go to OUT as
    JSON."""
    port, rank, out, path, tmp, mode, device = argv
    if device == "cuda" and not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    import torch.distributed as dist

    from tpuparquet_torch.shard import MultiHostScan, initialize, make_mesh

    dev = torch.device(device, 0) if device == "cuda" \
        else torch.device(device)
    initialize(f"localhost:{port}", 2, int(rank))
    ckpt = os.path.join(tmp, "ckpt")
    if mode == "scan":
        got = _multihost_scan(path, ckpt, dev)
    else:
        scan = MultiHostScan(
            [path], mesh=make_mesh() if dev.type == "cuda"
            else make_mesh(devices=[dev]), resume_from=ckpt,
            checkpoint_every=1)
        got = {"taken": [scan.local_units[k] for k, _ in scan.run_iter()]}
    with open(out, "w") as f:
        json.dump(got, f)
    dist.destroy_process_group()
    return 0


def _run_pair(path: str, tmp: str, mode: str, dev) -> list:
    """Run the two processes of one phase-7 mode and return their JSON
    findings by rank.  Each process writes its output to a log file of
    its own; when one fails, its peer (blocked in a collective) is
    killed at once, and a failure raises with both logs' ends; both are
    killed after 600 s."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    outs = [os.path.join(tmp, f"{mode}{r}.json") for r in (0, 1)]
    logs = [os.path.join(tmp, f"{mode}{r}.log") for r in (0, 1)]
    procs = []
    try:
        for r in (0, 1):
            with open(logs[r], "w") as log:
                procs.append(subprocess.Popen(
                    [sys.executable, os.path.abspath(__file__),
                     "--multihost-child", str(port), str(r), outs[r], path,
                     tmp, mode, dev.type], stdout=log,
                    stderr=subprocess.STDOUT))
        deadline = time.monotonic() + 600
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs) \
                    or time.monotonic() > deadline:
                break
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    if any(p.returncode != 0 for p in procs):
        tails = []
        for r, p in enumerate(procs):
            with open(logs[r]) as f:
                tails.append(f"process {r} (exit {p.returncode}):\n"
                             f"{f.read()[-3000:]}")
        raise AssertionError(f"7 {mode}: a process failed\n"
                             + "\n".join(tails))
    found = []
    for o in outs:
        with open(o) as f:
            found.append(json.load(f))
    return found


def _summed_hists(states: list) -> dict:
    """The bucket-wise sum of several collectors' ``to_state()``
    histograms, in their sparse JSON form."""
    out: dict = {}
    for hists in states:
        for name, h in hists.items():
            tot = out.setdefault(name, {"n": 0, "total": 0, "counts": {}})
            tot["n"] += h["n"]
            tot["total"] += h["total"]
            for b, c in h["counts"].items():
                tot["counts"][b] = tot["counts"].get(b, 0) + c
    return {name: dict(h, counts=dict(sorted(h["counts"].items(),
                                             key=lambda kv: int(kv[0]))))
            for name, h in sorted(out.items())}


def check_fleet_folds(states: list, folds: list) -> None:
    """7a's folds of A.11 part 2: every process's ``allgather_digests``,
    ``allgather_profiles`` and ``allgather_ledgers`` equal the merge of
    the processes' own states in process order, exactly (integer counts,
    float seconds summed in the same order)."""
    from tpuparquet_torch.obs.attribution import merge_ledger_states
    from tpuparquet_torch.obs.digest import DigestRegistry
    from tpuparquet_torch.obs.profiler import merge_profile_states

    reg = DigestRegistry()
    for st in states:
        reg.merge_state(st["digests"])
    want = {"digests": json.loads(json.dumps(reg.to_state())),
            "profile": merge_profile_states([st["profile"]
                                             for st in states]),
            "ledgers": {k: v.to_state() for k, v in merge_ledger_states(
                [st["ledgers"] for st in states]).items()}}
    for r, fold in enumerate(folds):
        for name in want:
            if fold[name] != want[name]:
                raise AssertionError(f"7a process {r}: allgather of the "
                                     f"{name} is not the processes' merge")
    units = [st["digests"]["scan.p{}".format(i)]["unit"]["n"]
             for i, st in enumerate(states)]
    samples = [st["profile"]["counters"]["profile_samples"]
               for st in states]
    print(f"7a fleet folds: digests (unit n {units} -> "
          f"{sum(units)}), profiles (samples {samples} -> "
          f"{want['profile']['counters']['profile_samples']}), ledgers "
          f"({sorted(want['ledgers'])}) equal the merge of the processes' "
          "states on both processes", flush=True)


def check_multihost(blob, results, run_1p: float, n_values: int,
                    dev) -> dict:
    """Phase 7: two processes scan config 2's file with ``MultiHostScan``
    over a gloo group, each on a mesh of ``dev`` (the card: both share
    it).  7a: every unit's checksum as gathered equals this process's
    own read (``results``, phase 6a's units), the fleet's ``row_groups``,
    ``chunks`` and ``values`` equal the footers' and the fleet is the sum
    of the processes, and each process launched config 2's kernels.  7b:
    both stop after their first unit with per-process checkpoints, two
    fresh processes resume, and the four runs yield every unit once.
    7c: ``run()`` timed as the slowest process's wall, best of 3, at the
    default plan workers and at half the usable CPUs each, beside phase
    6a's one-process ``run()`` (``run_1p``).  Returns the launches of
    7a's two ``run_with_stats()``, summed."""
    from tpuparquet_torch.io.reader import FileReader
    from tpuparquet_torch.shard import host_cursor_path

    rgs = FileReader(blob).meta.row_groups
    units = [[0, i] for i in range(len(rgs))]
    want = [unit_checksum(out) for out in results]
    footers = {"row_groups": len(rgs),
               "chunks": sum(len(rg.columns) for rg in rgs),
               "values": sum(cc.meta_data.num_values for rg in rgs
                             for cc in rg.columns)}
    here = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory(prefix=".smoke-", dir=here) as tmp:
        path = os.path.join(tmp, "config2.parquet")
        with open(path, "wb") as f:
            f.write(blob)
        t0 = time.perf_counter()
        pair = _run_pair(path, tmp, "scan", dev)
        t1 = time.perf_counter()
        ckpt = os.path.join(tmp, "ckpt")
        missing = [r for r in (0, 1)
                   if not os.path.exists(host_cursor_path(ckpt, r))]
        if missing:
            raise AssertionError(f"7b: no checkpoint of process(es) "
                                 f"{missing}")
        resumed = _run_pair(path, tmp, "resume", dev)
        t2 = time.perf_counter()
    launches = dict.fromkeys(pair[0]["launches"], 0)
    hosts = [got["local"] for got in pair]
    for r, got in enumerate(pair):
        label = f"7a process {r}"
        if dev.type == "cuda" and got["mesh"] != [str(dev)]:
            raise AssertionError(f"{label}: mesh {got['mesh']}, expected "
                                 f"the card {dev}")
        if got["local_units"] != units[r::2]:
            raise AssertionError(f"{label}: units {got['local_units']}")
        if got["checksums"] != want:
            raise AssertionError(f"{label}: the gathered checksums differ "
                                 "from this process's reads")
        if got["counts"] != [rg.num_rows for rg in rgs]:
            raise AssertionError(f"{label}: counts {got['counts']}")
        fleet = got["fleet"]
        _no_ladder(label, fleet)
        if {k: fleet[k] for k in footers} != footers:
            raise AssertionError(f"{label}: fleet {fleet}, footers "
                                 f"{footers}")
        if {k: v for k, v in fleet.items() if k != "hists"} != {
                k: (max if k == "wall_s" else sum)(h[k] for h in hosts)
                for k in fleet if k != "hists"} \
                or fleet.get("hists") != _summed_hists(
                    [h.get("hists") or {} for h in hosts]):
            raise AssertionError(f"{label}: the fleet is not the fold of "
                                 "the processes' counters and histograms")
        _need(label, got["launches"], MULTIHOST_KERNELS)
        print(f"{label} on {got['mesh']}: units {got['local_units']}, "
              f"launches {got['launches']}; wall_s "
              f"{got['local']['wall_s']:.4f}, plan_s "
              f"{got['local']['plan_s']:.4f}, transfer_s "
              f"{got['local']['transfer_s']:.4f}, dispatch_s "
              f"{got['local']['dispatch_s']:.4f}", flush=True)
        for k, c in got["launches"].items():
            launches[k] += c
    check_fleet_folds([got["states"] for got in pair],
                      [got["folds"] for got in pair])
    print(f"7a: the gathered checksums of {len(units)} units equal the "
          f"one-process reads; fleet {footers} as the footers, wall_s "
          f"{pair[0]['fleet']['wall_s']:.4f} (the slower process)",
          flush=True)
    seen = [tuple(u) for got in pair + resumed for u in got["taken"]]
    if not all(got["stopped"] and len(got["taken"]) == 1 for got in pair) \
            or sorted(seen) != [tuple(u) for u in units]:
        raise AssertionError(f"7b: stopped runs took "
                             f"{[got['taken'] for got in pair]}, resumed "
                             f"runs {[got['taken'] for got in resumed]}")
    print(f"7b: two stopped runs and two resumed runs yielded each of the "
          f"{len(units)} units once", flush=True)
    for workers, wall in pair[0]["walls"]:
        print(f"7c config 2 run() on two processes at {workers} plan "
              f"workers each, the slower process best of 3: {wall:.4f} s, "
              f"{n_values / wall:.4e} values/s (6a, one process at "
              f"{_plan_workers(None)} workers: {run_1p:.4f} s)", flush=True)
    print(f"phase 7 (the multi-process scan): 7a and 7c {t1 - t0:.2f} s, "
          f"7b's resume {t2 - t1:.2f} s, processes started included",
          flush=True)
    return launches


def read_kernel_splits(dev, n_values: int = 50_000_000,
                       n_groups: int = 8) -> None:
    """K1, K2, K4 and K5 at phase 4's shapes, their inputs rebuilt from
    the generator (config 2's row group 0: payment_type's def levels,
    rate_code's index stream and trip_distance_mm's page through the plane
    planner), K1 also at widths 3, 13 and 32 over 2^21 random lanes and K2
    on a run-dense stream (2^21 width-1 slots from ``_runny``, staged in
    table mode): each held against its plain version, with its device time
    and CUDA launches a call.  Calls only ``bitunpack.unpack_u32``,
    ``hybrid.expand_hybrid``, ``decode.levels_to_validity`` and
    ``decode.planes_to_words``, whose signatures the parent shares, so the
    same function loaded from this checkout's chip_smoke.py (importlib, by
    path) times an older checkout's kernels from that checkout's
    directory."""
    from tpuparquet_torch.kernels.bitunpack import unpack_u32, \
        unpack_u32_plain
    from tpuparquet_torch.kernels.decode import levels_to_validity, \
        levels_to_validity_plain, planes_to_words, planes_to_words_plain
    from tpuparquet_torch.kernels.hybrid import expand_hybrid, \
        expand_hybrid_plain

    cols, pay_mask = config2_groups(n_values, n_groups)[0]
    n = pay_mask.size
    rng = np.random.default_rng(21)
    k1_d, k1_cnt, _ = k1_page(pay_mask, dev)
    k2_bp, k2_tbl, k2_cnt, k2_nbp, _, _ = k2_page(cols, dev)
    dense = _stream(_runny(rng, 1 << 21, 1), 1, dev)
    wide = {w: _one_run(rng.integers(0, 1 << w, size=1 << 21,
                                     dtype=np.uint64), w, 1 << 21, dev)
            for w in (3, 13, 32)}
    levels = k4_levels(pay_mask, dev)
    staged, _, spec, _ = k5_page(cols, dev)
    cpu_staged = [t.cpu() for t in staged]
    calls = [
        ("K1 page", lambda: unpack_u32(k1_d, 1, k1_cnt),
         lambda: unpack_u32_plain(k1_d, 1, k1_cnt)),
        *((f"K1 width {w}", lambda w=w: unpack_u32(wide[w], w, 1 << 21),
           lambda w=w: unpack_u32_plain(wide[w], w, 1 << 21))
          for w in wide),
        ("K2 page", lambda: expand_hybrid(k2_bp, k2_tbl, k2_cnt, 3, k2_nbp),
         lambda: expand_hybrid_plain(k2_bp, k2_tbl, k2_cnt, 3, k2_nbp)),
        ("K2 run-dense", lambda: expand_hybrid(*dense[:3], 1, dense[3]),
         lambda: expand_hybrid_plain(*dense[:3], 1, dense[3])),
        ("K4", lambda: levels_to_validity(levels, 1),
         lambda: levels_to_validity_plain(levels, 1)),
        ("K5", lambda: planes_to_words(*staged, spec, n, 2),
         lambda: planes_to_words_plain(*cpu_staged, spec, n, 2))]
    for name, fn, plain in calls:
        got, want = fn(), plain()
        err = max(_max_err(g, w) for g, w in zip(
            got if isinstance(got, tuple) else (got,),
            want if isinstance(want, tuple) else (want,)))
        if err:
            raise AssertionError(f"{name}: max abs diff {err} against the "
                                 "plain version")
        split = device_split(fn, tries=6)
        print(f"{name} split: device {_us(split)} a call, {split[1]:g} CUDA "
              f"launches ({split[2]}); max_abs_err 0", flush=True)


def bss_pages(dev, n_values: int = 50_000_000, n_groups: int = 8) -> list:
    """K12's inputs at the shapes of the splits: ``[(name, raw, count, k,
    lanes)]`` on ``dev``, the sensor table's reading page (doubles) and
    temp page (floats) of row group 0 rebuilt from its generator, k 6 (2
    lanes) at 1,000,003 rows, k 16 (4 lanes) at 2^20 + 3, k 1,031 (258
    lanes) at 4,099 rows, and the reading page from a view 5 bytes into
    its buffer."""
    from tpuparquet_torch.cpu.bss import encode_byte_stream_split

    cols, _ = sensor_groups(n_values // 4 // n_groups, 1)[0]
    rng = np.random.default_rng(29)
    reading = np.frombuffer(encode_byte_stream_split(cols["reading"]),
                            np.uint8)
    temp = np.frombuffer(encode_byte_stream_split(cols["temp"]), np.uint8)
    nr, nt = cols["reading"].size, cols["temp"].size

    def rand(k, count):
        return _t(rng.integers(0, 256, size=k * count, dtype=np.uint8), dev)

    return [
        ("reading page", _t(reading, dev), nr, 8, 2),
        ("temp page", _t(temp, dev), nt, 4, 1),
        ("k 6 at 1,000,003", rand(6, 1_000_003), 1_000_003, 6, 2),
        ("k 16 at 2^20 + 3", rand(16, (1 << 20) + 3), (1 << 20) + 3, 16, 4),
        ("k 1,031 at 4,099", rand(1031, 4099), 4099, 1031, 258),
        ("reading page 5 bytes in", _t(np.concatenate(
            [np.zeros(5, np.uint8), reading]), dev)[5:], nr, 8, 2)]


def bss_kernel_splits(dev, n_values: int = 50_000_000,
                      n_groups: int = 8) -> None:
    """K12 alone on each page of :func:`bss_pages`, held against its plain
    version, with its device time, CUDA launches a call and bound; then
    on the reading page again with the L2 cache flushed before each call.
    Calls only ``decode.bss_to_lanes``, whose signature the parent
    shares, so the same function loaded from this checkout's
    chip_smoke.py (importlib, by path) times an older checkout's K12 from
    that checkout's directory."""
    import re

    from tpuparquet_torch.kernels.decode import bss_to_lanes, \
        bss_to_lanes_plain

    pages = bss_pages(dev, n_values, n_groups)
    for name, raw, count, k, lanes in pages:
        def fn(raw=raw, count=count, k=k, lanes=lanes):
            return bss_to_lanes(raw, count, k, lanes)

        err = _max_err(fn(), bss_to_lanes_plain(raw, count, k, lanes))
        if err:
            raise AssertionError(f"K12 {name}: max abs diff {err} against "
                                 "the plain version")
        bound, _ = _bound_ms(k * count + 4 * lanes * count, 0)
        split = device_split(fn, tries=6)
        print(f"K12 {name} split: device {_us(split)} a call, {split[1]:g} "
              f"CUDA launches ({split[2]}); bound {1e3 * bound:.1f} us; "
              "max_abs_err 0", flush=True)
    # back to back, a call finds part of its input in the 50 MB L2; a
    # 64 MiB read before each call leaves it cold
    name, raw, count, k, lanes = pages[0]
    flush = torch.zeros(64 << 20, dtype=torch.uint8, device=dev)
    split = device_split(lambda: (flush.sum(), bss_to_lanes(raw, count, k,
                                                            lanes)), tries=6)
    kernel = re.search(r"bss_to_lanes_kernel ([\d.]+ us)", split[2])
    print(f"K12 {name}, the L2 flushed before each call: device "
          f"{kernel.group(1) if kernel else 'not traced'} a call ({split[2]})",
          flush=True)


# K12's loads by the Tensor Memory Accelerator: one thread a stream
# copies the segment's aligned covering range into its shared-memory row
# with one 1-D bulk copy, completed on an mbarrier the block waits on
_K12_LOAD = "__device__ __forceinline__ void load_tile("
_K12_LOAD_END = "// Rows r .. r + 3"
_K12_BULK_LOAD = r"""__device__ __forceinline__ void load_tile(
    const uint8_t* __restrict__ raw, int64_t count, int64_t i0, int rows,
    int s0, int ns, int stride, uint8_t* sm) {
  __shared__ __align__(8) uint64_t bar;
  const uint32_t b = static_cast<uint32_t>(__cvta_generic_to_shared(&bar));
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" :: "r"(b));
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  for (int j = threadIdx.x; j < ns; j += kThreads) {
    const uint8_t* seg = raw + (s0 + j) * count + i0;
    const int d = static_cast<int>(reinterpret_cast<uintptr_t>(seg) & 15);
    const uint32_t bytes = static_cast<uint32_t>((d + rows + 15) & ~15);
    const uint32_t dst =
        static_cast<uint32_t>(__cvta_generic_to_shared(sm + j * stride));
    asm volatile("mbarrier.expect_tx.shared::cta.b64 [%0], %1;"
                 :: "r"(b), "r"(bytes) : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1], %2, [%3];"
        :: "r"(dst), "l"(seg - d), "r"(bytes), "r"(b) : "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" :: "r"(b)
                 : "memory");
  }
  asm volatile(
      "{\n\t.reg .pred P1;\n"
      "LAB_WAIT:\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n\t"
      "@P1 bra DONE;\n\t"
      "bra LAB_WAIT;\n"
      "DONE:\n\t}" :: "r"(b), "r"(0) : "memory");
}

"""


def bss_variants(dev, n_values: int = 50_000_000, n_groups: int = 8) -> None:
    """K12 as built at other tile sizes (the wrapper's rows; KE2's rule,
    the largest multiple of 16 whose rows fit 16 KiB, which takes two
    rounds of loads a thread; 1,024 and 512 rows), and built from this
    checkout's source with what its design left behind: 5 loads a thread
    in flight (one round at KE2's rule), its loads made by the Tensor
    Memory Accelerator (``_K12_BULK_LOAD``; its mbarrier's 8 bytes of
    static shared memory do not fit beside k 1,031's full 48 KB, so not
    on that page), each thread storing its own 16-byte chunks instead of
    a warp's staged ones, and registers capped at 32 a thread (8 blocks
    an SM).  Timed on the device on each page of :func:`bss_pages` but
    the view; each is held against the plain version.  Calls the kernels
    directly, so it counts no launch."""
    from tpuparquet_torch.kernels import _lib
    from tpuparquet_torch.kernels._lib import stream_of
    from tpuparquet_torch.kernels.decode import bss_lanes_tile_rows, \
        bss_to_lanes_plain

    _lib.build_kernels()
    built = _build_variants({
        "5 loads a thread": ("bss_to_lanes", _variant("bss_to_lanes", _sub(
            "constexpr int kVecs = 4;", "constexpr int kVecs = 5;"))),
        "bulk copy": ("bss_to_lanes", _variant("bss_to_lanes", _span(
            _K12_LOAD, _K12_LOAD_END, _K12_BULK_LOAD))),
        "thread stores": ("bss_to_lanes", _variant("bss_to_lanes", _sub(
            "if (L > 1 && 4 * (base + 32) <= rows) {", "if (false) {"))),
        "32 registers": ("bss_to_lanes", _variant("bss_to_lanes", _sub(
            "__launch_bounds__(kThreads)", "__launch_bounds__(kThreads, 8)")))})
    for name, raw, count, k, lanes in bss_pages(dev, n_values,
                                                n_groups)[:5]:
        want = bss_to_lanes_plain(raw, count, k, lanes)
        t0 = bss_lanes_tile_rows(lanes)
        ke2 = max(16, (16384 // (4 * lanes)) & ~15)
        designs = [
            ("as built", _lib._fns["bss_to_lanes"],
             sorted({t0, ke2, 1024, 512}, reverse=True)),
            ("5 loads a thread", built["5 loads a thread"], (ke2,)),
            ("bulk copy", built["bulk copy"],
             sorted({t0, ke2}) if lanes <= 4 else ()),
            ("thread stores", built["thread stores"], (t0,)),
            ("32 registers", built["32 registers"], (t0,))]
        row = []
        for label, fn, tiles in designs:
            for tile in tiles:
                out = torch.empty(count * lanes, dtype=torch.int32,
                                  device=dev)

                def call(fn=fn, tile=tile, out=out, raw=raw, count=count,
                         k=k, lanes=lanes, label=label):
                    rc = fn(raw.data_ptr(), count, k, lanes, tile,
                            out.data_ptr(), stream_of(out))
                    if rc:
                        raise RuntimeError(f"K12 {label} tile {tile}: "
                                           f"cudaError {rc}")
                    return out

                _same(f"K12 {label} tile {tile} {name}", call(), want)
                row.append(f"{label} tile {tile} "
                           f"{_us(device_split(call, tries=6))} "
                           f"({k12_moved(raw, count, k, lanes, tile):.4f} "
                           "bytes a byte out)")
        print(f"K12 variants, {name}: {', '.join(row)}", flush=True)


def read_passes(dev, cache: str, reps: int = 5,
                n_values: int = 50_000_000, n_groups: int = 8) -> None:
    """Host-clock A/B of the reads: config 2, the string mix, the
    Spark-style table and the parquet-mr v2 table, each read ``reps``
    times after one warm pass, printed as one JSON line of ``[pass s,
    plan_s, dispatch_s]`` a pass.  The files are written once into the
    directory ``cache`` and read from there after, so runs of this
    function loaded by path from several checkouts (in turns) read the
    same bytes through each checkout's ``tpuparquet_torch``."""
    from tpuparquet_torch.io.reader import FileReader
    from tpuparquet_torch.kernels.device import read_row_groups_device
    from tpuparquet_torch.stats import collect_stats

    builds = {"config 2": build_config2, "string mix": build_strings,
              "spark table": build_spark, "parquet-mr v2 table": build_mr_v2}
    out = {}
    for name, build in builds.items():
        path = os.path.join(cache, name.replace(" ", "_") + ".parquet")
        if not os.path.exists(path):
            with open(path + ".tmp", "wb") as f:
                f.write(build(n_values, n_groups)[0])
            os.replace(path + ".tmp", path)
        with open(path, "rb") as f:
            reader = FileReader(f.read())
        out[name] = []
        for k in range(reps + 1):
            with collect_stats() as st:
                t0 = time.perf_counter()
                outs = [o for _, o in read_row_groups_device(reader,
                                                             device=dev)]
                _sync(dev)
                dt = time.perf_counter() - t0
            del outs
            if k:
                out[name].append([dt, st.plan_s, st.dispatch_s])
    print(json.dumps(out), flush=True)


def single_reads(dev, cache: str, reps: int = 5,
                 n_values: int = 50_000_000, n_groups: int = 8) -> None:
    """Host-clock A/B of ``read_row_group_device``, the one-unit read of
    the quarantining scan: config 2 (written once into ``cache``) read
    one row group a call, every row group in turn, ``reps`` passes after
    one warm pass, at the default plan workers and at
    ``TPQ_PLAN_THREADS=1``.  Prints one JSON line of ``[pass s, plan_s,
    dispatch_s]`` a pass for each worker setting."""
    from tpuparquet_torch.io.reader import FileReader
    from tpuparquet_torch.kernels.device import read_row_group_device
    from tpuparquet_torch.stats import collect_stats

    path = os.path.join(cache, "build_config2.parquet")
    if not os.path.exists(path):
        with open(path + ".tmp", "wb") as f:
            f.write(build_config2(n_values, n_groups)[0])
        os.replace(path + ".tmp", path)
    with open(path, "rb") as f:
        reader = FileReader(f.read())
    out = {}
    saved = os.environ.get("TPQ_PLAN_THREADS")
    try:
        for label, workers in (("default", saved), ("1", "1")):
            if workers is None:
                os.environ.pop("TPQ_PLAN_THREADS", None)
            else:
                os.environ["TPQ_PLAN_THREADS"] = workers
            out[label] = []
            for k in range(reps + 1):
                with collect_stats() as st:
                    t0 = time.perf_counter()
                    for rg in range(reader.row_group_count()):
                        read_row_group_device(reader, rg, device=dev)
                    _sync(dev)
                    dt = time.perf_counter() - t0
                if k:
                    out[label].append([dt, st.plan_s, st.dispatch_s])
    finally:
        if saved is None:
            os.environ.pop("TPQ_PLAN_THREADS", None)
        else:
            os.environ["TPQ_PLAN_THREADS"] = saved
    print(json.dumps(out), flush=True)


def multihost_ab(dev, rounds: int = 2, n_values: int = 50_000_000,
                 n_groups: int = 8) -> None:
    """Host-clock A/B of phase 7c in turns (one process, two processes,
    two, one; ``rounds`` times) on config 2's file: this process's
    ``ShardedScan.run()`` on the default mesh, best of 3, against the
    slower of two processes' ``MultiHostScan.run()``, best of 3, at the
    default plan workers and at half the usable CPUs each (a fresh pair
    of processes each time, as phase 7 starts them).  Prints one JSON
    line of the walls in order."""
    from tpuparquet_torch.shard import ShardedScan, make_mesh

    blob, _ = build_config2(n_values, n_groups)
    mesh = make_mesh() if dev.type == "cuda" else make_mesh(devices=[dev])
    scan = ShardedScan([blob], mesh=mesh)

    def run():
        scan.run()
        _sync(dev)

    walls = []
    here = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory(prefix=".smoke-", dir=here) as tmp:
        path = os.path.join(tmp, "config2.parquet")
        with open(path, "wb") as f:
            f.write(blob)
        for r in range(rounds):
            for side in ("one", "two", "two", "one"):
                if side == "one":
                    walls.append(["one", _best_run(
                        f"multihost_ab round {r} one process run()", run)])
                    continue
                for name in os.listdir(tmp):  # a fresh pair, a fresh 7b
                    if name != "config2.parquet":
                        os.unlink(os.path.join(tmp, name))
                got = _run_pair(path, tmp, "scan", dev)[0]["walls"]
                print(f"multihost_ab round {r} two processes: {got}",
                      flush=True)
                walls.append(["two", got])
    print(json.dumps({"multihost_ab": walls}), flush=True)


def host_gathers(dev, reps: int = 3, n_values: int = 50_000_000,
                 n_groups: int = 8) -> None:
    """Host-clock A/B of the gathers onto the host (``gather_to="cpu"``,
    the direct assembly) over config 2's and config 4's files on phase
    6's meshes: each column's best of ``reps``, printed as one JSON line
    of ``{label: [wall s, gather_reshard_s, bytes]}``.  Calls only
    ``ShardedScan`` and its gathers, so loaded from this file by path in
    another checkout's directory it times that checkout's assembly."""
    from tpuparquet_torch.shard import ShardedScan
    from tpuparquet_torch.stats import collect_stats

    blob2, groups2 = build_config2(n_values, n_groups)
    files = (("config 2", blob2, list(groups2[0][0]), []),
             ("config 4", build_config4(n_values, n_groups)[0],
              ["fare", "tip"], ["vendor", "note"]))
    out = {}
    for mlabel, mesh in shard_meshes(dev):
        for flabel, blob, fixed, byte_cols in files:
            scan = ShardedScan([blob], mesh=mesh)
            results = scan.run()
            for name in fixed + byte_cols:
                gather = (scan.gather_byte_column if name in byte_cols
                          else scan.gather_column)
                best = (float("inf"), None, None)
                for _ in range(reps):
                    with collect_stats() as st:
                        t0 = time.perf_counter()
                        gather(results, name, gather_to="cpu")
                        _sync(dev)
                        dt = time.perf_counter() - t0
                    if dt < best[0]:
                        best = (dt, st.gather_reshard_s,
                                st.gather_bytes_moved)
                out[f"{flabel} {mlabel} {name}"] = list(best)
            scan.close()
    print(json.dumps(out), flush=True)


def shard_kernel_splits(dev, n_values: int = 50_000_000,
                        n_groups: int = 8) -> None:
    """KS2 and KS3 at phase 4's shapes, their inputs rebuilt from the
    generators (config 2's dictionary index streams; config 4's note, row
    group 0 as ``read_row_group_device`` decodes it, which is how the
    scan decodes unit 0): each held against its plain version, with its
    device time and CUDA launches a call.  Calls only
    ``gather.spmd_step_slot`` and ``gather.byte_densify``, whose
    signatures the parent shares, so the same function loaded from this
    checkout's chip_smoke.py (importlib, by path) times an older
    checkout's kernels from that checkout's directory."""
    from tpuparquet_torch.io.reader import FileReader
    from tpuparquet_torch.kernels.device import read_row_group_device
    from tpuparquet_torch.kernels.gather import byte_densify, \
        byte_densify_plain, spmd_step_slot, spmd_step_slot_plain

    blob, _ = build_config2(n_values, n_groups)
    call2 = ks2_call(dict_index_streams(FileReader(blob)), dev)[0]
    blob4, _ = build_config4(n_values, n_groups)
    col = read_row_group_device(FileReader(blob4), 0, device=dev)["note"]
    call3 = ks3_call(col, dev)[0]
    for name, call, fn, plain in (
            ("KS2", call2, spmd_step_slot, spmd_step_slot_plain),
            ("KS3", call3, byte_densify, byte_densify_plain)):
        got, want = call(fn), call(plain)
        err = max(_max_err(g, w) for g, w in zip(
            got if isinstance(got, tuple) else (got,),
            want if isinstance(want, tuple) else (want,)))
        if err:
            raise AssertionError(f"{name}: max abs diff {err} against the "
                                 "plain version")
        split = device_split(lambda: call(fn))
        print(f"{name} split: device {_us(split)} a call, {split[1]:g} CUDA "
              f"launches ({split[2]}); max_abs_err 0", flush=True)


def time_shard_kernels(c2, c4, streams_by_col, dev, launches) -> list:
    """Phase 4, the sharded scan: KS1-KS4 at phase 6's shapes (row group
    0 of config 2 and config 4 as the 1x1 scan decoded them, the first
    dictionary column's batch of 6d, config 2's pickup_ts block of the
    2x2 mesh)."""
    from tpuparquet_torch.kernels.decode import scatter_to_dense, \
        scatter_to_dense_plain
    from tpuparquet_torch.kernels.gather import byte_densify, \
        byte_densify_plain, densify_tile_slots, place_rows, \
        place_rows_plain, spmd_step_slot, spmd_step_slot_plain, \
        spmd_tile_positions
    from tpuparquet_torch.shard.scan import _shard_major

    out = []

    def row(*args, **kw):
        return _kernel_row(out, launches, *args, **kw)

    # KS1: config 2's payment_type, unit 0 (5% nulls); one PyTorch call
    # pair computes it: index_select, then where
    col = c2["results"][0]["payment_type"]
    packed, m, p = col.data, col.mask, col.positions
    n, nn = col.num_values, col.n_packed
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    row("scatter_to_dense", "tpuparquet_torch/csrc/scatter_dense.cu",
        "tpuparquet/kernels/decode.py:197 scatter_to_dense",
        lambda: scatter_to_dense(packed, m, p, 1),
        lambda: scatter_to_dense_plain(packed, m, p, 1),
        n + 4 * n + 4 * nn + 4 * n, n,
        library=lambda: torch.where(m, packed.index_select(0, p), zero))
    # KS2: the first dictionary column's 6d batch, the one slot of the 1x1
    # mesh (every unit, every position)
    call, in_bytes, out_bytes, moved = ks2_call(streams_by_col, dev)
    split = row("spmd_step_slot", "tpuparquet_torch/csrc/spmd_step.cu",
                "tpuparquet/shard/mesh.py:310 decode_step_spmd",
                lambda: call(spmd_step_slot),
                lambda: call(spmd_step_slot_plain), in_bytes + out_bytes,
                out_bytes // 4)
    print(f"KS2 batch, tiles of {spmd_tile_positions()} positions: "
          f"{split[1]:g} CUDA launches a call ({split[2]}); "
          f"{moved / out_bytes:.4f} bytes moved per output byte by the "
          "design's arithmetic", flush=True)
    want = call(spmd_step_slot_plain)
    times = []
    for t in (128, 256, 512):
        def at_tile(t=t):
            return call(lambda *args: _step_at_tile(t, *args))

        _same(f"KS2 at a tile of {t}", at_tile(), want)
        times.append(f"{t} {_us(device_split(at_tile))}")
    print(f"KS2 tile sizes (positions: device time a call): "
          f"{', '.join(times)}", flush=True)
    # KS3: config 4's optional note, unit 0 (40% nulls); one PyTorch call
    # computes its core, the running sum of the slot lengths
    col = c4["results"][0]["note"]
    call, n_bytes, library = ks3_call(col, dev)
    moved = ks3_moved(col.num_values + 1, col.n_bytes, n_bytes)
    split = row("byte_densify", "tpuparquet_torch/csrc/byte_densify.cu",
                "tpuparquet/shard/scan.py:1711 gather_byte_column (densify "
                ":1748-1772)",
                lambda: call(byte_densify), lambda: call(byte_densify_plain),
                n_bytes, col.num_values, library=library)
    print(f"KS3 note unit 0, tiles of {densify_tile_slots()} slots: "
          f"{split[1]:g} CUDA launches a call "
          f"({split[2]}); {moved / n_bytes:.4f} bytes moved per byte of the "
          "function's count by the design's arithmetic", flush=True)
    # KS4: config 2's pickup_ts as the 2x2 mesh assembles it (8 units,
    # shard-major), permuted to unit order on device 0; one PyTorch call
    # computes it: index_select
    vals = c2["out"]["pickup_ts"][0]
    _, _, perm = _shard_major(vals.shape[0], 2, 2)
    x = torch.empty((vals.shape[0], vals[0].size), dtype=torch.int32,
                    device=dev)
    x[torch.from_numpy(perm).to(dev)] = torch.from_numpy(
        vals.reshape(vals.shape[0], -1).view(np.int32)).to(dev)
    rows_t = torch.from_numpy(perm).to(dev)
    row("place_rows", "tpuparquet_torch/csrc/place_rows.cu",
        "tpuparquet/shard/scan.py:1616 _place_streams (place :1631-1638)",
        lambda: place_rows(x, perm, len(perm), len(perm)),
        lambda: place_rows_plain(x, rows_t, len(perm), len(perm)),
        2 * x.numel() * 4, x.numel(),
        library=lambda: x.index_select(0, rows_t))
    return out


# ----------------------------------------------------------------------
# Phase 8: consumer meshes and the resilient read ladder
# ----------------------------------------------------------------------

def _consumer(dev, shape, names):
    """A consumer mesh of ``prod(shape)`` slots, every slot ``dev``."""
    from tpuparquet_torch.shard.mesh import Mesh

    grid = np.empty(shape, dtype=object)
    for ix in np.ndindex(*shape):
        grid[ix] = dev
    return Mesh(grid, names)


def _check_sharded(label, name, placed, rep, n_units, target) -> None:
    """8a: every shard of ``placed`` lies on its slot's device and holds
    its piece; rows past ``n_units`` are zero; the assembled global
    equals the replicated gather ``rep`` bit for bit."""
    slots = list(target.mesh.devices.flat)
    if [sh.device for sh in placed.addressable_shards] != slots:
        raise AssertionError(f"{label} {name}: shards not in slot order")
    for sh, dev in zip(placed.addressable_shards, slots):
        if sh.data.device != dev:
            raise AssertionError(f"{label} {name}: a shard is on "
                                 f"{sh.data.device}, its slot is {dev}")
    full = placed.to_numpy()
    if full.dtype == np.int32 and rep.dtype == np.uint32:
        full = full.view(np.uint32)
    if full.shape[0] % target.partitions(0) or full.shape[1:] \
            != rep.shape[1:] or full[n_units:].any():
        raise AssertionError(f"{label} {name}: padding rows not zero or "
                             f"shape {full.shape} against {rep.shape}")
    if not np.array_equal(full[:n_units], rep):
        raise AssertionError(f"{label} {name}: the sharded gather differs "
                             "from the replicated gather")


def check_consumer_meshes(label, mesh, scans, reader, dev,
                          wrappers) -> dict:
    """Phase 8a over phase 6's 1x1 results (``scans``: ``[(file label,
    check_sharded_scan's result, fixed columns, byte columns)]``): each
    column under ``NamedSharding(<2 slots of dev>, P("data"))``, and each
    two-lane fixed column under ``NamedSharding(<2x2 slots>, P("data",
    None, "model"))``, checked by :func:`_check_sharded`; then
    ``read_row_groups_device(reader, out_sharding=...)`` over the 2-slot
    mesh, whose units must equal the first scan's and sit on their
    slots.  The counts are set to 0 just before; returns the launches."""
    from tpuparquet_torch.kernels.device import read_row_groups_device
    from tpuparquet_torch.shard import gather_byte_column, gather_column
    from tpuparquet_torch.shard.mesh import NamedSharding, PartitionSpec

    P = PartitionSpec
    two = NamedSharding(_consumer(dev, (2,), ("data",)), P("data"))
    four = NamedSharding(_consumer(dev, (2, 2), ("data", "model")),
                         P("data", None, "model"))
    for fn in wrappers.values():
        fn.launches = 0
    checked = []
    for flabel, got, fixed, byte_cols in scans:
        results = got["results"]
        n = len(results)
        for name in fixed:
            rep = got["out"][name][0]
            v, _ = gather_column(mesh, results, name, out_sharding=two)
            _check_sharded(f"{label} {flabel}", name, v, rep, n, two)
            checked.append(f"{name} over 2")
            if rep.shape[2] % 2 == 0:
                v, _ = gather_column(mesh, results, name,
                                     out_sharding=four)
                _check_sharded(f"{label} {flabel}", name, v, rep, n, four)
                checked.append(f"{name} over 2x2")
        for name in byte_cols:
            o, d, _, _ = gather_byte_column(mesh, results, name,
                                            out_sharding=two)
            ro, rd = got["out"][name][:2]
            _check_sharded(f"{label} {flabel}", f"{name} offsets", o, ro, n,
                           two)
            _check_sharded(f"{label} {flabel}", f"{name} data", d, rd, n,
                           two)
            checked.append(f"{name} over 2")
    _sync(dev)
    first = scans[0][1]["results"]
    placed = list(read_row_groups_device(reader, out_sharding=two))
    _sync(dev)
    slots = list(two.mesh.devices.flat)
    for (rg, cols), want in zip(placed, first):
        for path, col in cols.items():
            if col.data.device != slots[rg % len(slots)]:
                raise AssertionError(f"{label}: row group {rg} is on "
                                     f"{col.data.device}")
        if unit_checksum(cols) != unit_checksum(want):
            raise AssertionError(f"{label}: row group {rg} read onto the "
                                 "consumer mesh differs from 6a's unit")
    if len(placed) != len(first):
        raise AssertionError(f"{label}: {len(placed)} row groups read")
    launches = {k: fn.launches for k, fn in wrappers.items()}
    print(f"{label} launches: {launches}; sharded gathers {checked} equal "
          f"the replicated gathers; {len(placed)} row groups read onto "
          f"{len(slots)} consumer slots equal 6a's units", flush=True)
    return launches


def _same_units(label, got: dict, want: list, skip=()) -> None:
    """Every unit of ``got`` ({unit: columns}) equals unit k of ``want``
    (6a's), by their checksums on the card, but the units in ``skip``."""
    for k, cols in got.items():
        if k in skip:
            continue
        if unit_checksum(cols) != unit_checksum(want[k]):
            raise AssertionError(f"{label}: unit {k} differs from 6a's")


def _same_values_of(label, cols, want) -> None:
    """One unit's columns against 6a's, value for value (``to_numpy``;
    a degraded unit's buffers are not padded as a kernel's are)."""
    for path, col in cols.items():
        a, b = col.to_numpy(), want[path].to_numpy()
        for x, y in zip(a, b):
            if not _same_values(np.asarray(x), y):
                raise AssertionError(f"{label}: {path} differs from 6a's")


def check_resilient(label, mesh, blob, results, dev, wrappers,
                    unit: int = 3, budget: float = 2.0) -> dict:
    """Phase 8b: ``ShardedScan([blob], on_error="quarantine", retries=2)``
    over config 2 under ``inject_faults()``, injected faults only, each
    case's counts set to 0 just before; ``results`` are 6a's units.
    Returns the launches of the four cases."""
    from tpuparquet_torch.deadline import _drain_workers_at_exit
    from tpuparquet_torch.faults import inject_faults
    from tpuparquet_torch.io.reader import FileReader
    from tpuparquet_torch.kernels.device import read_row_group_device, \
        read_row_group_device_resilient
    from tpuparquet_torch.shard import ShardedScan
    from tpuparquet_torch.stats import collect_stats

    total = dict.fromkeys(wrappers, 0)

    def scan(rules, **kw):
        for fn in wrappers.values():
            fn.launches = 0
        with collect_stats() as st, inject_faults() as inj:
            for site, kind, rkw in rules:
                inj.inject(site, kind, **rkw)
            s = ShardedScan([blob], mesh=mesh, on_error="quarantine",
                            retries=2, **kw)
            t0 = time.perf_counter()
            got = dict(s.run_iter())
            _sync(dev)
            wall = time.perf_counter() - t0
        # an abandoned deadline worker runs on once its hang is released:
        # join it before the counts are read
        _drain_workers_at_exit()
        _sync(dev)
        for k, fn in wrappers.items():
            total[k] += fn.launches
        return got, s, st, wall

    n_units = len(results)
    with collect_stats() as unit_st:
        read_row_group_device(FileReader(blob), unit, device=dev)
    unit_pages = unit_st.pages
    rule = ("kernels.device.unit_dispatch", "dispatch")
    got, s, st, _ = scan([rule + ({"times": 1, "after": unit},)])
    if (st.dispatch_retries, st.units_degraded, st.pages_degraded,
            len(got), len(s.quarantine)) != (1, 0, 0, n_units, 0):
        raise AssertionError(f"{label} dispatch once: {st}")
    _same_units(f"{label} dispatch once", got, results)
    print(f"{label}: unit_dispatch failing once on unit {unit}: "
          f"dispatch_retries 1, units_degraded 0, faults_injected "
          f"{st.faults_injected}; every unit equals 6a's", flush=True)

    got, s, st, _ = scan([rule + ({"times": 3, "after": unit},)])
    if (st.dispatch_retries, st.units_degraded, st.pages_degraded,
            len(got)) != (2, 1, unit_pages, n_units):
        raise AssertionError(f"{label} dispatch thrice: dispatch_retries "
                             f"{st.dispatch_retries}, units_degraded "
                             f"{st.units_degraded}, pages_degraded "
                             f"{st.pages_degraded} (the unit has "
                             f"{unit_pages} data pages)")
    _same_units(f"{label} dispatch thrice", got, results, skip=(unit,))
    _same_values_of(f"{label} degraded unit {unit}", got[unit],
                    results[unit])
    # the degraded unit alone: its levels on the card, no K3
    for fn in wrappers.values():
        fn.launches = 0
    with inject_faults() as inj:
        inj.inject(*rule, times=3)
        read_row_group_device_resilient(FileReader(blob), unit, retries=2,
                                        device=dev)
    _sync(dev)
    alone = {k: fn.launches for k, fn in wrappers.items()}
    for k, c in alone.items():
        total[k] += c
    if alone["page_dict_fixed"] or (dev.type == "cuda"
                                    and not alone["levels_to_validity"]):
        raise AssertionError(f"{label}: the degraded unit launched "
                             f"{alone}")
    print(f"{label}: unit_dispatch failing 3 times on unit {unit}: "
          f"dispatch_retries 2, units_degraded 1, pages_degraded "
          f"{st.pages_degraded} (its data pages); its values equal 6a's; "
          f"alone it launched {alone} (no K3)", flush=True)

    col = sorted(results[0])[-1]
    got, s, st, _ = scan([("kernels.device.page_payload", "corrupt",
                           {"match": {"column": col}, "times": 1})])
    (e,) = s.quarantine.entries
    if (e["unit"], e["file"], e["row_group"], e.get("column"), e["error"],
            st.units_quarantined) != (0, 0, 0, col, "CorruptPageError", 1) \
            or sorted(got) != list(range(1, n_units)):
        raise AssertionError(f"{label} corrupt page: {s.quarantine.entries}")
    _same_units(f"{label} corrupt page", got, results)
    print(f"{label}: a corrupt page of {col}: {e}; the other units equal "
          "6a's", flush=True)

    got, s, st, wall = scan([("kernels.device.hang", "hang",
                              {"times": 1, "after": unit})],
                            unit_deadline=budget)
    (e,) = s.quarantine.entries
    if (e["unit"], e["error"], st.deadline_exceeded) != \
            (unit, "DeadlineExceededError", 1) \
            or not budget <= e["elapsed_s"] <= budget + 1.0:
        raise AssertionError(f"{label} hang: {s.quarantine.entries}")
    _same_units(f"{label} hang", got, results)
    print(f"{label}: a hung dispatch on unit {unit} under unit_deadline="
          f"{budget:g}: quarantined as DeadlineExceededError after "
          f"{e['elapsed_s']} s (scan {wall:.2f} s); the other units equal "
          "6a's", flush=True)
    print(f"{label} launches: {total}", flush=True)
    return total


def time_resilient(label, mesh, blob, dev, run_6a: float) -> float:
    """Phase 8c: ``run()`` in quarantine mode with no fault, best of 3,
    beside 6a's pipelined ``run()`` (``run_6a``); the ladder's counters
    stay 0."""
    from tpuparquet_torch.shard import ShardedScan
    from tpuparquet_torch.stats import collect_stats

    s = ShardedScan([blob], mesh=mesh, on_error="quarantine")

    def run():
        with collect_stats() as st:
            s.run()
            _sync(dev)
        _no_ladder(label, st)
        if st.units_quarantined:
            raise AssertionError(f"{label}: {s.quarantine.entries}")

    best = _best_run(f"{label} run() in quarantine mode", run)
    print(f"{label}: quarantine mode {best:.4f} s against 6a's pipelined "
          f"run() {run_6a:.4f} s ({best / run_6a:.2f}x)", flush=True)
    return best


# ----------------------------------------------------------------------
# Phase 9: filtered reads (predicate pushdown, late materialization)
# ----------------------------------------------------------------------

# 9a's data pages: 65,536 level slots a page; its bloom columns
SPLIT_PAGE_ROWS = 65_536
BLOOM_COLUMNS = ["rate_code", "passenger_count"]
BLOOM_SCHEMA = "message bloom { required int64 id; required int32 even; }"
# the read kernels, which no filtered read may launch: it decodes on the
# host and copies the surviving rows
READ_KERNELS = ("unpack_u32", "expand_hybrid", "page_dict_fixed",
                "levels_to_validity", "planes_to_words", "unpack_u64",
                "delta_scan", "expand_tokens", "page_dict_bytes",
                "plain_bytes_from_blob", "scatter_deltas", "bss_to_lanes",
                "flba_bytes_to_lanes")
PRUNE_COUNTERS = ("row_groups_pruned", "pages_pruned", "rows_pruned",
                  "bloom_hits", "filter_rows_in", "filter_rows_out")


def _take_rows(values, keep: np.ndarray):
    """The values at the True entries of ``keep``: an array's rows, or a
    byte column's values (offsets rebased from 0)."""
    if isinstance(values, np.ndarray):
        return values[keep]
    from tpuparquet_torch.cpu.plain import ByteArrayColumn

    idx = np.flatnonzero(keep)
    offs = np.asarray(values.offsets, dtype=np.int64)
    lens = (offs[1:] - offs[:-1])[idx]
    new = np.zeros(idx.size + 1, dtype=np.int64)
    np.cumsum(lens, out=new[1:])
    src = np.repeat(offs[:-1][idx] - new[:-1], lens) + np.arange(
        int(new[-1]), dtype=np.int64)
    return ByteArrayColumn(new, np.asarray(values.data)[src])


def _post_filter(groups, keeps):
    """The generator's row groups cut to the rows ``keeps[i]`` (a bool a
    row of group i): ``[(columns, masks)]``, the post-filter a filtered
    read must equal."""
    out = []
    for (cols, masks), keep in zip(groups, keeps):
        c2, m2 = {}, {}
        for name, vals in cols.items():
            mask = masks.get(name)
            if mask is None:
                c2[name] = _take_rows(vals, keep)
            else:
                c2[name] = _take_rows(vals, keep[mask])
                m2[name] = mask[keep]
        out.append((c2, m2))
    return out


def _filtered_reads(reader, f, dev, threads=None):
    """``read_row_groups_device(filter=f)`` on ``dev``: ``(outputs,
    collector)``."""
    from tpuparquet_torch.kernels.device import read_row_groups_device
    from tpuparquet_torch.stats import collect_stats

    with _plan_threads_env(threads), collect_stats() as st:
        got = list(read_row_groups_device(reader, device=dev, filter=f))
        _sync(dev)
    return got, st


def _best_filtered(label, reader, f, dev, reps: int, threads=None) -> float:
    """Best of ``reps`` filtered passes, printed with the best pass's
    phase split; returns its wall."""
    best, phases = float("inf"), None
    for _ in range(reps):
        t0 = time.perf_counter()
        got, st = _filtered_reads(reader, f, dev, threads)
        dt = time.perf_counter() - t0
        del got
        if dt < best:
            best, phases = dt, st
    print(f"{label} at {_plan_workers(threads)} plan workers, best of "
          f"{reps}: {best:.4f} s; plan_s {phases.plan_s:.4f} (the host "
          f"decode, summed), transfer_s {phases.transfer_s:.4f}, "
          f"rows out {phases.filter_rows_out}", flush=True)
    return best


def _same_counts(label, st, want: dict) -> None:
    got = {k: getattr(st, k) for k in want}
    print(f"{label} counters: {got}", flush=True)
    if got != want:
        raise AssertionError(f"{label}: counters {got}, expected {want}")


def _check_filtered_read(label, reader, f, dev, groups, keeps, want,
                         wrappers) -> None:
    """One filtered read on the card: the kept row groups' every value,
    level and mask against the generator's post-filter, the first kept
    row group against the same read on the CPU buffer for buffer, the
    pruning counters against ``want``, and no read kernel launched."""
    from tpuparquet_torch.kernels.device import read_row_group_device

    for fn in wrappers.values():
        fn.launches = 0
    got, st = _filtered_reads(reader, f, dev)
    launched = {k: wrappers[k].launches for k in READ_KERNELS
                if wrappers[k].launches}
    if launched:
        raise AssertionError(f"{label}: the filtered read launched "
                             f"{launched}")
    kept = [rg for rg in range(len(groups)) if rg not in want["pruned"]]
    if [rg for rg, _ in got] != kept:
        raise AssertionError(f"{label}: row groups {[rg for rg, _ in got]}"
                             f" read, expected {kept}")
    _check_values(label, got, _post_filter([groups[rg] for rg in kept],
                                           [keeps[rg] for rg in kept]))
    if kept:
        cpu = read_row_group_device(reader, kept[0], filter=f, device="cpu")
        for name, col in got[0][1].items():
            a, b = col.padded_buffers(), cpu[name].padded_buffers()
            if a.keys() != b.keys() or not all(
                    a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])
                    for k in a):
                raise AssertionError(f"{label} row group {kept[0]} {name}:"
                                     " cuda and cpu buffers differ")
    _same_counts(label, st, {k: want[k] for k in PRUNE_COUNTERS})
    print(f"{label}: {len(kept)} row groups read, "
          f"{sum(int(k.sum()) for k in keeps)} rows match the generator's "
          "post-filter", flush=True)


def _want_counts(keeps, cands, pruned, page_rows: int, n_cols: int,
                 filter_cols: int) -> dict:
    """The pruning counters a filtered read of config 2's split-page file
    must give, from the generator: ``keeps`` the surviving rows of each
    row group, ``cands`` the page-index candidate pages of each (None:
    every page), ``pruned`` the row groups the statistics prune.  The
    filter's columns decode the candidate pages, the others the pages
    holding a surviving row."""
    want = dict.fromkeys(PRUNE_COUNTERS, 0)
    want["pruned"] = pruned
    for rg, (keep, cand) in enumerate(zip(keeps, cands)):
        n = keep.size
        if rg in pruned:
            want["row_groups_pruned"] += 1
            want["rows_pruned"] += n
            continue
        n_pages = -(-n // page_rows)
        page_of = np.arange(n) // page_rows
        cand_rows = n if cand is None else int(cand[page_of].sum())
        want["rows_pruned"] += n - cand_rows
        want["filter_rows_in"] += cand_rows
        want["filter_rows_out"] += int(keep.sum())
        if cand is not None:
            want["pages_pruned"] += filter_cols * int(n_pages - cand.sum())
        if keep.sum() < n:
            with_rows = np.unique(page_of[keep]).size
            want["pages_pruned"] += (n_cols - filter_cols) * (
                n_pages - with_rows)
    return want


def check_filtered(dev, n_values: int, n_groups: int, wrappers, reps: int = 3,
                   page_rows: int = SPLIT_PAGE_ROWS, strings=None,
                   bloom_rows: int = 10_000_000) -> dict:
    """Phase 9.  9a: config 2's values written with ``page_rows``-slot
    pages, the page index and bloom filters on ``BLOOM_COLUMNS``, read
    unfiltered on the card (every value against the generator, row
    group 0 against the CPU run).  9b: ``read_row_groups_device(filter=)``
    of four filters (a prefix of every row group the page index narrows;
    nothing the statistics keep; a dictionary equality with a null test;
    every row), each checked against the generator's post-filter with
    exact pruning counters and no read kernel launched, and timed best
    of ``reps`` at the default and at one plan worker.  9c: a table of
    ``bloom_rows`` rows whose int32 column holds even values only,
    filtered on an odd value inside its bounds: every row group pruned by
    its bloom filter, no page read.  9d: ``ShardedScan(filter=)`` over
    9a's file and the string mix (``strings``: its ``(file bytes,
    groups)``, else written here), the gathers against the post-filter,
    KS1 and KS3 launching.  ``reps=0`` checks without timing.  Returns
    the launches of 9a and 9d."""
    from tpuparquet_torch.filter import col
    from tpuparquet_torch.io.reader import FileReader
    from tpuparquet_torch.shard import ShardedScan, make_mesh

    t9 = time.perf_counter()
    total = dict.fromkeys(wrappers, 0)
    groups = config2_groups(n_values, n_groups)
    g2 = [(c, {"payment_type": m}) for c, m in groups]
    rows = groups[0][0]["pickup_ts"].size
    blob = _write(SCHEMA, g2, None, page_rows=page_rows,
                  bloom_columns=BLOOM_COLUMNS)
    reader = FileReader(blob)
    n_pages = sum(len(p) for rg in range(n_groups)
                  for p in reader.page_index(rg).values())
    print(f"9a config 2 in {page_rows}-slot pages: {len(blob)} bytes, "
          f"{n_pages} data pages, blooms on {BLOOM_COLUMNS}", flush=True)
    got, launches, _st = _drive(reader, dev, wrappers)
    print(f"9a launches: {launches}", flush=True)
    n_all = _check_read("9a config 2 split pages", reader, got, g2)
    del got
    _need("9a config 2 split pages", launches,
          ["unpack_u32", "page_dict_fixed", "levels_to_validity"])
    for k, c in launches.items():
        total[k] += c
    walls = {t: _best_one("9a config 2 split pages, unfiltered", reader,
                          dev, n_all, reps, threads=t)
             for t in ((None, 1) if reps else ())}

    # 9b: four filters
    base_ts = 1_700_000_000_000
    limit = base_ts + 180_000 * rows  # about a tenth of each row group
    ts = [c["pickup_ts"] for c, _ in groups]
    filters = [
        ("9b pickup_ts prefix", col("pickup_ts") < limit,
         [t < limit for t in ts],
         # ascending timestamps: a page is a candidate when its first
         # value is under the limit
         [t[::page_rows] < limit for t in ts], [], 1),
        ("9b trip_distance_mm > 50000", col("trip_distance_mm") > 50_000,
         [np.zeros(rows, bool)] * n_groups, [None] * n_groups,
         list(range(n_groups)), 1),
        ("9b rate_code == 3 & payment_type not null",
         (col("rate_code") == 3) & col("payment_type").not_null(),
         [(c["rate_code"] == 3) & m for c, m in groups],
         [None] * n_groups, [], 2),
        ("9b trip_distance_mm >= 0", col("trip_distance_mm") >= 0,
         [np.ones(rows, bool)] * n_groups, [None] * n_groups, [], 1),
    ]
    for label, f, keeps, cands, pruned, n_filter_cols in filters:
        cands = [None if c is None or c.all() else c for c in cands]
        want = _want_counts(keeps, cands, pruned, page_rows, 5,
                            n_filter_cols)
        _check_filtered_read(label, reader, f, dev, g2, keeps, want,
                             wrappers)
        if reps:
            fw = {t: _best_filtered(label, reader, f, dev, reps, t)
                  for t in (None, 1)}
            print(f"{label} pass wall: {fw[None]:.4f} s at "
                  f"{_plan_workers(None)} workers, {fw[1]:.4f} s at 1; the "
                  f"unfiltered pass {walls[None]:.4f} s / {walls[1]:.4f} s",
                  flush=True)

    # 9c: the bloom level
    rng = np.random.default_rng(29)
    per = bloom_rows // n_groups
    bgroups = [({"id": np.arange(i * per, (i + 1) * per, dtype=np.int64),
                 "even": 2 * rng.integers(0, 30_000, per, dtype=np.int32)},
                {}) for i in range(n_groups)]
    breader = FileReader(_write(BLOOM_SCHEMA, bgroups, None,
                                bloom_columns=["even"]))
    blooms = [breader.bloom_filter(rg, "even") for rg in range(n_groups)]
    # the first odd value every chunk's bloom filter refutes (each admits
    # about 1% of absent values)
    odd = next(v for v in range(30_001, 60_000, 2) if not any(
        b.check(np.int32(v).tobytes()) for b in blooms))
    verdicts = [breader.prune_row_group(col("even") == odd, rg)
                for rg in range(n_groups)]
    if any((v.skip, v.reason, v.bloom_hits) != (True, "bloom", 1)
           for v in verdicts):
        raise AssertionError("9c: verdicts " + str(
            [(v.skip, v.reason, v.bloom_hits) for v in verdicts]))
    got, st = _filtered_reads(breader, col("even") == odd, dev)
    _same_counts("9c even == odd", st, {
        "row_groups_pruned": n_groups, "rows_pruned": per * n_groups,
        "bloom_hits": n_groups, "pages_pruned": 0, "filter_rows_in": 0,
        "chunks": 0, "pages": 0})
    if got:
        raise AssertionError(f"9c: {len(got)} row groups read")
    print(f"9c even == {odd}: all {n_groups} row groups pruned by their "
          "bloom filters, no page read", flush=True)

    # 9d: filtered scans on the default mesh
    one = (make_mesh() if dev.type == "cuda" else make_mesh(devices=[dev]))
    if strings is None:
        strings = build_strings(n_values, n_groups)
    blob_s, groups_s = strings
    scans = (
        ("9d config 2 pickup_ts prefix", blob, g2, filters[0][1],
         filters[0][2], list(groups[0][0]), [], "scatter_to_dense"),
        ("9d string mix token < '2'", blob_s, groups_s, col("token") < "2",
         [_token_keep(c["token"], m["token"]) for c, m in groups_s],
         [], ["url", "url_opt", "token"], "byte_densify"))
    for label, fblob, fgroups, f, keeps, fixed, byte_cols, need in scans:
        for fn in wrappers.values():
            fn.launches = 0
        scan = ShardedScan([fblob], mesh=one, filter=f)
        results = scan.run()
        want = _post_filter(fgroups, keeps)
        target = 0 if dev.type == "cuda" else dev
        for name in fixed + byte_cols:
            gather = (scan.gather_byte_column if name in byte_cols
                      else scan.gather_column)
            rep = gather(results, name)
            if name in byte_cols:
                _check_bytes_gather(label, name, rep, want)
            else:
                _check_fixed_gather(label, name, rep, want, results)
            _same_gather(label, name, gather(results, name,
                                             gather_to=target), rep,
                         "to device 0")
        _sync(dev)
        launches = {k: fn.launches for k, fn in wrappers.items()}
        print(f"{label} launches: {launches}", flush=True)
        _need(label, launches, [need])
        for k, c in launches.items():
            total[k] += c
        counts = [int(r[(fixed + byte_cols)[0]].num_values)
                  for r in results]
        print(f"{label}: {len(results)} units of {counts} rows; every "
              "gathered unit matches the generator's post-filter",
              flush=True)
        if reps:
            _best_run(f"{label} run()", lambda: (scan.run(), _sync(dev)),
                      reps)
        scan.close()
    print(f"phase 9 (filtered reads): {time.perf_counter() - t9:.2f} s",
          flush=True)
    return total


def _token_keep(token, mask) -> np.ndarray:
    """Rows whose ``token`` is not null and sorts below ``b"2"``."""
    keep = np.zeros(mask.size, bool)
    first = np.asarray(token.data)[np.asarray(token.offsets[:-1])]
    keep[np.flatnonzero(mask)] = first < ord("2")
    return keep


# ----------------------------------------------------------------------
# Phase 10: torn-file salvage, strict metadata, hedged replica reads and
# decode_chunk_device
# ----------------------------------------------------------------------

# 10c's hang of each primary chunk read, and its hedge delay
HEDGE_HANG_S = 3.0
HEDGE_DELAY_S = 0.05


def _launches_of(wrappers) -> dict:
    return {k: fn.launches for k, fn in wrappers.items()}


def _zero(wrappers) -> None:
    for fn in wrappers.values():
        fn.launches = 0


def _rg_ends(meta) -> list:
    """Each row group's last byte + 1, from a footer."""
    ends = []
    for rg in meta.row_groups:
        end = 0
        for cc in rg.columns:
            cm = cc.meta_data
            start = cm.data_page_offset
            if cm.dictionary_page_offset is not None:
                start = min(start, cm.dictionary_page_offset)
            end = max(end, start + cm.total_compressed_size)
        ends.append(end)
    return ends


def damaged_copies(blob: bytes) -> list:
    """10a's damaged copies of ``blob`` (written with a salvage hint):
    ``[(label, bytes, expected row groups)]``, each count worked out
    from the intact footer before the cut: a cut at row group 4's end, a
    cut mid-page in row group 5, a cut inside a page header of row group
    6, the footer's length flipped, and a footer that lies about row
    group 3's second chunk (its data page before the head magic) over
    intact pages."""
    from tpuparquet_torch.format.footer import read_file_metadata, \
        write_footer

    meta = read_file_metadata(io.BytesIO(blob))
    ends = _rg_ends(meta)
    n = len(ends)

    def count(cut):
        return sum(1 for e in ends if e <= cut)

    out = []
    k = min(4, n)
    out.append(("cut at a row-group boundary", ends[k - 1], count(
        ends[k - 1])))
    cm = meta.row_groups[min(5, n - 1)].columns[1].meta_data
    start = cm.data_page_offset
    if cm.dictionary_page_offset is not None:
        start = min(start, cm.dictionary_page_offset)
    # the chunk's data page runs from data_page_offset to its end
    cut = (cm.data_page_offset + start + cm.total_compressed_size) // 2
    out.append(("cut mid-page", cut, count(cut)))
    cm = meta.row_groups[min(6, n - 1)].columns[2].meta_data
    cut = cm.data_page_offset + 3
    out.append(("cut inside a page header", cut, count(cut)))
    copies = [(label, blob[:cut], want) for label, cut, want in out]
    flipped = bytearray(blob)
    for i in range(len(blob) - 8, len(blob) - 4):
        flipped[i] ^= 0xFF
    copies.append(("flipped footer bytes", bytes(flipped), n))
    (flen,) = np.frombuffer(blob[-8:-4], "<u4")
    body = blob[: len(blob) - 8 - int(flen)]
    meta.row_groups[min(3, n - 1)].columns[1].meta_data.data_page_offset = 2
    buf = io.BytesIO()
    buf.write(body)
    write_footer(buf, meta)
    copies.append(("lying footer", buf.getvalue(), n))
    return copies


def _best_open(fn, reps: int = 3) -> float:
    best = None
    for _ in range(reps):
        t0 = time.perf_counter()
        fn().close()
        dt = time.perf_counter() - t0
        best = dt if best is None else min(best, dt)
    return best


def check_salvage(blob, groups, results, mesh, dev, wrappers) -> dict:
    """Phase 10a and 10b.  10a: each of :func:`damaged_copies` opened
    with ``salvage=True`` (the forward scan), its recovered row groups
    read on the card (the counts set to 0 just before): every buffer
    equal to the intact file's read of the same row groups, which equals
    the generator; ``files_salvaged`` 1 and ``row_groups_recovered`` the
    expected count; config 2's kernels launch.  The lying footer under
    ``strict_metadata=True`` without salvage raises
    ``CorruptFooterError`` and counts ``metadata_rejects`` 1.  The salvage
    open is timed beside a plain open, best of 3.  10b:
    ``ShardedScan([intact, torn], on_error="quarantine", salvage=True)``
    on the 1x1 mesh: the torn file's entry is ``"salvaged"`` and its
    prefix units equal 6a's units and the generator.  Returns the
    launches."""
    from tpuparquet_torch.errors import CorruptFooterError
    from tpuparquet_torch.io.reader import FileReader
    from tpuparquet_torch.shard import ShardedScan
    from tpuparquet_torch.stats import collect_stats

    total = dict.fromkeys(wrappers, 0)
    g2 = [(c, {"payment_type": m}) for c, m in groups]
    base, _, _ = _drive(FileReader(blob), dev, wrappers)
    _check_values("10a intact", base, g2)
    plain_s = _best_open(lambda: FileReader(blob))
    print(f"10a: intact config 2, {len(blob)} bytes, salvage hint at "
          f"offset 4; plain open {plain_s:.6f} s (best of 3)", flush=True)
    torn = None
    for label, data, want in damaged_copies(blob):
        with collect_stats() as st:
            r = FileReader(data, salvage=True)
        got_counts = (st.files_salvaged, st.row_groups_recovered,
                      r.row_group_count())
        if got_counts != (1, want, want):
            raise AssertionError(f"10a {label}: files_salvaged, "
                                 f"row_groups_recovered, row groups "
                                 f"{got_counts}, expected (1, {want}, "
                                 f"{want})")
        got, launches, _ = _drive(r, dev, wrappers)
        _same_columns(f"10a {label}", got, base[:want])
        _need(f"10a {label}", launches, CONFIG2_KERNELS)
        for k, c in launches.items():
            total[k] += c
        open_s = _best_open(lambda: FileReader(data, salvage=True))
        rep = r.salvage_report
        print(f"10a {label}: {len(data)} bytes, {want} row groups "
              f"recovered (schema from the {rep['schema_source']}, stop "
              f"{rep['stop_reason']}), every buffer equal to the intact "
              f"read; salvage open {open_s:.6f} s (plain {plain_s:.6f}); "
              f"launches {launches}", flush=True)
        if label == "lying footer":
            with collect_stats() as st:
                try:
                    FileReader(data, strict_metadata=True)
                except CorruptFooterError as e:
                    err = e
                else:
                    raise AssertionError("10a lying footer: the strict "
                                         "open did not raise")
            if st.metadata_rejects != 1 or not err.findings:
                raise AssertionError(f"10a lying footer strict: "
                                     f"metadata_rejects "
                                     f"{st.metadata_rejects}")
            print(f"10a lying footer, strict_metadata=True: {err}; "
                  "metadata_rejects 1", flush=True)
        if label == "cut mid-page":
            torn = (data, want)
        del got, r
    del base

    data, want = torn
    _zero(wrappers)
    with collect_stats() as st:
        s = ShardedScan([blob, data], mesh=mesh, on_error="quarantine",
                        salvage=True)
        t0 = time.perf_counter()
        got = dict(s.run_iter())
        _sync(dev)
        wall = time.perf_counter() - t0
    launches = _launches_of(wrappers)
    for k, c in launches.items():
        total[k] += c
    (e,) = s.quarantine.entries
    n_units = len(results)
    if (e["disposition"], e["file"], e["row_groups_recovered"],
            st.files_salvaged, st.row_groups_recovered,
            len(got)) != ("salvaged", 1, want, 1, want, n_units + want):
        raise AssertionError(f"10b: {s.quarantine.entries}, "
                             f"{len(got)} units")
    torn_units = {k: cols for k, cols in got.items()
                  if s.units[k][0] == 1}
    _same_units("10b intact units", {k: got[k] for k in range(n_units)},
                results)
    _same_units("10b torn units", {s.units[k][1]: cols
                                   for k, cols in torn_units.items()},
                results)
    _check_values("10b torn units", [(s.units[k][1], cols) for k, cols
                                     in sorted(torn_units.items())],
                  g2[:want])
    _need("10b", launches, CONFIG2_KERNELS)
    print(f"10b: ShardedScan(on_error='quarantine', salvage=True) over "
          f"[intact, torn]: {len(got)} units in {wall:.4f} s; the torn "
          f"file's entry {e}; its {want} units equal 6a's and the "
          f"generator; launches {launches}", flush=True)
    s.close()
    return total


def check_hedged(blob, results, mesh, dev, wrappers,
                 phase3_s: float) -> dict:
    """Phase 10c: config 2 on disk beside a byte-equal mirror; every
    chunk read of the primary hangs (``io.chunk.hang``, HEDGE_HANG_S)
    and hedges to the mirror after HEDGE_DELAY_S.  A plain pass from the
    path first (timed); then ``read_row_groups_device`` over
    ``FileReader(p, mirrors=[m])`` equals it buffer for buffer with
    ``hedges_won`` at least the chunk reads (timed beside it and phase
    3's pass); ``ShardedScan([[p, m]], on_error="quarantine")`` equals
    6a's units with nothing quarantined; without a mirror and with
    ``read_deadline=1`` (no retry) a read of ``pickup_ts`` raises
    ``DeadlineExceededError`` within its budget and 1 s, counting
    ``deadline_exceeded``.  Returns the
    launches of the hedged read and scan."""
    from tpuparquet_torch.deadline import _drain_workers_at_exit
    from tpuparquet_torch.errors import DeadlineExceededError
    from tpuparquet_torch.faults import inject_faults
    from tpuparquet_torch.io.reader import FileReader
    from tpuparquet_torch.kernels.device import read_row_group_device, \
        read_row_groups_device
    from tpuparquet_torch.shard import ShardedScan
    from tpuparquet_torch.stats import collect_stats

    total = dict.fromkeys(wrappers, 0)
    with tempfile.TemporaryDirectory(
            prefix=".smoke-", dir=os.path.dirname(
                os.path.abspath(__file__))) as tmp:
        p, m = os.path.join(tmp, "p.parquet"), os.path.join(tmp,
                                                           "m.parquet")
        for path in (p, m):
            with open(path, "wb") as f:
                f.write(blob)
        n_chunks = sum(len(rg.columns)
                       for rg in FileReader(blob).meta.row_groups)
        with FileReader(p) as r:
            t0 = time.perf_counter()
            plain = list(read_row_groups_device(r, device=dev))
            _sync(dev)
            plain_s = time.perf_counter() - t0

        _zero(wrappers)
        with collect_stats() as st, inject_faults() as inj:
            inj.inject("io.chunk.hang", "hang", times=10**6,
                       seconds=HEDGE_HANG_S, match={"file": p})
            with FileReader(p, mirrors=[m],
                            hedge_delay=HEDGE_DELAY_S) as r:
                t0 = time.perf_counter()
                got = list(read_row_groups_device(r, device=dev))
                _sync(dev)
                hedged_s = time.perf_counter() - t0
        _drain_workers_at_exit()
        launches = _launches_of(wrappers)
        for k, c in launches.items():
            total[k] += c
        _same_columns("10c hedged read", got, plain)
        _need("10c hedged read", launches, CONFIG2_KERNELS)
        if st.hedges_won < n_chunks or st.hedges_issued < st.hedges_won:
            raise AssertionError(f"10c hedged read: hedges_issued "
                                 f"{st.hedges_issued}, hedges_won "
                                 f"{st.hedges_won}, {n_chunks} chunk "
                                 "reads")
        print(f"10c hedged read: {n_chunks} chunk reads, hedges_issued "
              f"{st.hedges_issued}, hedges_won {st.hedges_won}; equal to "
              f"the plain read buffer for buffer; pass {hedged_s:.4f} s "
              f"hedged, {plain_s:.4f} s plain from the path, "
              f"{phase3_s:.4f} s phase 3's best; launches {launches}",
              flush=True)
        del got, plain

        _zero(wrappers)
        with collect_stats() as st, inject_faults() as inj:
            inj.inject("io.chunk.hang", "hang", times=10**6,
                       seconds=HEDGE_HANG_S, match={"file": p})
            s = ShardedScan([[p, m]], mesh=mesh, on_error="quarantine",
                            hedge_delay=HEDGE_DELAY_S)
            t0 = time.perf_counter()
            got = dict(s.run_iter())
            _sync(dev)
            wall = time.perf_counter() - t0
            s.close()
        _drain_workers_at_exit()
        launches = _launches_of(wrappers)
        for k, c in launches.items():
            total[k] += c
        if len(s.quarantine) or len(got) != len(results) \
                or st.hedges_won < n_chunks:
            raise AssertionError(f"10c hedged scan: {len(got)} units, "
                                 f"quarantine {s.quarantine.entries}, "
                                 f"hedges_won {st.hedges_won}")
        _same_units("10c hedged scan", got, results)
        print(f"10c ShardedScan([[p, m]], on_error='quarantine'): "
              f"{len(got)} units equal to 6a's, nothing quarantined, "
              f"hedges_won {st.hedges_won}, run {wall:.4f} s; launches "
              f"{launches}", flush=True)
        del got, s

        old = os.environ.get("TPQ_IO_RETRIES")
        os.environ["TPQ_IO_RETRIES"] = "0"
        budget = 1.0
        try:
            with collect_stats() as st, inject_faults() as inj:
                inj.inject("io.chunk.hang", "hang", times=10**6,
                           seconds=HEDGE_HANG_S, match={"file": p})
                t0 = time.perf_counter()
                try:
                    # one column: its read runs on this thread, whose
                    # collector counts the expiry
                    with FileReader(p, "pickup_ts",
                                    read_deadline=budget) as r:
                        read_row_group_device(r, 0, device=dev)
                except DeadlineExceededError as e:
                    err, took = e, time.perf_counter() - t0
                else:
                    raise AssertionError("10c: a hung read with no mirror "
                                         "did not raise")
            _drain_workers_at_exit()
        finally:
            if old is None:
                os.environ.pop("TPQ_IO_RETRIES", None)
            else:
                os.environ["TPQ_IO_RETRIES"] = old
        if not budget <= took <= budget + 1.0 or st.deadline_exceeded != 1:
            raise AssertionError(f"10c deadline: raised after {took:.3f} s, "
                                 f"deadline_exceeded "
                                 f"{st.deadline_exceeded}")
        print(f"10c no mirror, read_deadline={budget:g}: {err!r} after "
              f"{took:.3f} s, deadline_exceeded {st.deadline_exceeded}",
              flush=True)
    return total


def check_decode_chunk(reader, dev, wrappers) -> dict:
    """Phase 10d: ``decode_chunk_device`` over each column chunk of
    config 2's row group 0 (the counts set to 0 just before): every
    buffer equal to ``read_row_group_device``'s, config 2's kernels
    launching.  Returns the launches."""
    from tpuparquet_torch.kernels.device import decode_chunk_device, \
        read_row_group_device

    want = read_row_group_device(reader, 0, device=dev)
    _zero(wrappers)
    t0 = time.perf_counter()
    got = {}
    for path, node, cm in reader.selected_chunks(reader.meta.row_groups[0]):
        chunk, start = reader.chunk_blob(cm, path)
        got[path] = decode_chunk_device(chunk, cm, node, start, device=dev)
    _sync(dev)
    wall = time.perf_counter() - t0
    launches = _launches_of(wrappers)
    _same_columns("10d decode_chunk_device", [(0, got)], [(0, want)])
    _need("10d decode_chunk_device", launches, CONFIG2_KERNELS)
    print(f"10d decode_chunk_device: {len(got)} chunks of row group 0 in "
          f"{wall:.4f} s, every buffer equal to read_row_group_device's; "
          f"launches {launches}", flush=True)
    return launches


def check_robustness(blob, groups, results, mesh, reader, dev, wrappers,
                     phase3_s: float) -> dict:
    """Phase 10 (10a-10d); returns the launches of its paths."""
    t10 = time.perf_counter()
    total = dict.fromkeys(wrappers, 0)
    for launches in (
            check_salvage(blob, groups, results, mesh, dev, wrappers),
            check_hedged(blob, results, mesh, dev, wrappers, phase3_s),
            check_decode_chunk(reader, dev, wrappers)):
        for k, c in launches.items():
            total[k] += c
    print(f"phase 10 (salvage, strict metadata, hedged reads, "
          f"decode_chunk_device): {time.perf_counter() - t10:.2f} s",
          flush=True)
    return total


# ----------------------------------------------------------------------
# Phase 11: the writer's nested surface, and the telemetry
# ----------------------------------------------------------------------

NESTED_SCHEMA = """message trips {
  required int64 trip_id;
  optional group pickup { required int64 ts; optional int32 zone; }
  optional group fees (MAP) {
    repeated group key_value { required int32 key; optional int64 value; }
  }
  optional group stops (LIST) {
    repeated group list {
      optional group element { required int64 at; optional double lat; }
    }
  }
}"""

# slots a row of the nested table takes on average: trip_id, pickup.ts,
# pickup.zone, then two leaves of max(count, 1) slots for fees (counts
# 0-4) and for stops (counts 0-3)
NESTED_SLOTS_PER_ROW = 3 + 2 * 2.2 + 2 * 1.75


def build_nested(n_values: int, n_groups: int, seed: int = 23) -> list:
    """The nested table's row groups (about ``n_values`` level slots in
    all): ``[(columns, masks, offsets, element_masks, truth)]`` as
    ``FileWriter.write_columns`` takes them, ``truth`` the generator's
    per-row and per-element arrays the read is checked against.  An
    optional struct ``pickup {ts; optional zone}`` with null groups and
    null fields, a MAP<int32, int64> (two leaves on shared offsets, null
    rows, empty maps, null values) and a LIST of an optional
    struct<int64, double> (null rows, empty lists, null elements, null
    fields)."""
    rng = np.random.default_rng(seed)
    rows = max(int(n_values / NESTED_SLOTS_PER_ROW) // n_groups, 1)
    out = []
    for g in range(n_groups):
        # pickups null in blocks of 64 rows, so the def streams of the
        # struct hold RLE runs (K2) beside bit-packed ones (K1)
        pick = np.repeat(rng.random(rows // 64 + 1) < 0.9, 64)[:rows]
        zone_m = rng.random(rows) < 0.8
        fees_row = rng.random(rows) < 0.9
        fees_n = np.where(fees_row, rng.integers(0, 5, rows), 0)
        stops_row = rng.random(rows) < 0.9
        stops_n = np.where(stops_row, rng.integers(0, 4, rows), 0)
        foffs = np.zeros(rows + 1, np.int64)
        np.cumsum(fees_n, out=foffs[1:])
        soffs = np.zeros(rows + 1, np.int64)
        np.cumsum(stops_n, out=soffs[1:])
        nf, ns = int(foffs[-1]), int(soffs[-1])
        val_m = rng.random(nf) < 0.7
        gnull = rng.random(ns) < 0.1
        lat_m = rng.random(ns) < 0.75
        truth = {
            "trip_id": np.arange(g * rows, (g + 1) * rows, dtype=np.int64),
            "pickup": pick, "zone_m": zone_m,
            "ts": rng.integers(1_600_000_000_000, 1_700_000_000_000,
                               int(pick.sum()), dtype=np.int64),
            "zone": rng.integers(1, 266, int((pick & zone_m).sum()),
                                 dtype=np.int32),
            "fees_row": fees_row, "fees_offs": foffs,
            "key": rng.integers(0, 12, nf, dtype=np.int32),
            "value_m": val_m,
            "value": rng.integers(0, 10_000, int(val_m.sum()),
                                  dtype=np.int64),
            "stops_row": stops_row, "stops_offs": soffs,
            "gnull": gnull, "lat_m": lat_m,
            "at": rng.integers(0, 1 << 40, int((~gnull).sum()),
                               dtype=np.int64),
            "lat": rng.uniform(40.5, 41.0, int((lat_m & ~gnull).sum())),
        }
        cols = {"trip_id": truth["trip_id"], "pickup.ts": truth["ts"],
                "pickup.zone": truth["zone"],
                "fees": (truth["key"], truth["value"]),
                "stops": (truth["at"], truth["lat"])}
        masks = {"pickup": pick, "pickup.zone": zone_m, "fees": fees_row,
                 "stops": stops_row}
        offsets = {"fees": foffs, "stops": soffs}
        elems = {"fees": {"fees.key_value.value": val_m},
                 "stops": {"stops.list.element": gnull,
                           "stops.list.element.lat": lat_m}}
        out.append((cols, masks, offsets, elems, truth))
    return out


def _nested_on_card(cols: dict, dev) -> dict:
    """The nested table's columns as ``DeviceValues`` on ``dev`` (tuples
    of them for the repeated groups)."""
    from tpuparquet_torch.kernels.encode import DeviceValues

    def dv(a):
        a = np.ascontiguousarray(a)
        return DeviceValues(torch.from_numpy(a.view(np.int32)).to(dev),
                            a.dtype)

    return {k: tuple(dv(a) for a in v) if isinstance(v, tuple) else dv(v)
            for k, v in cols.items()}


def _want_nested(truth: dict) -> dict:
    """Each leaf's ``(values, rep, def)`` worked out slot by slot from the
    generator: a repeated row of ``c`` elements takes ``max(c, 1)``
    slots, a null row's slot has def 0 and an empty row's def 1; a MAP
    key is def 2 and its value 3 (2 when null); a LIST element's ``at``
    is def 3 (2 when the element is null) and its ``lat`` 4 (3 when
    null, 2 when the element is)."""
    rows = truth["trip_id"].size
    pick, zone_m = truth["pickup"], truth["zone_m"]
    flat0 = np.zeros(rows, np.int32)

    def repeated(offs, row_mask, elem_def):
        counts = np.diff(offs)
        slots = np.maximum(counts, 1)
        first = np.zeros(int(slots.sum()), bool)
        first[np.cumsum(slots) - slots] = True
        rep = np.where(first, 0, 1).astype(np.int32)
        row_of_slot = np.repeat(np.arange(counts.size), slots)
        has = counts[row_of_slot] > 0
        dl = np.empty(rep.size, np.int32)
        dl[~has] = np.where(row_mask[row_of_slot[~has]], 1, 0)
        dl[has] = elem_def
        return rep, dl

    gnull = truth["gnull"]
    at_def = np.where(gnull, 2, 3).astype(np.int32)
    lat_def = np.where(gnull, 2, np.where(truth["lat_m"], 4, 3)).astype(
        np.int32)
    return {
        "trip_id": (truth["trip_id"], flat0, flat0),
        "pickup.ts": (truth["ts"], flat0, pick.astype(np.int32)),
        "pickup.zone": (truth["zone"], flat0,
                        (pick.astype(np.int32) * (1 + zone_m))),
        "fees.key_value.key": (truth["key"], *repeated(
            truth["fees_offs"], truth["fees_row"], 2)),
        "fees.key_value.value": (truth["value"], *repeated(
            truth["fees_offs"], truth["fees_row"],
            np.where(truth["value_m"], 3, 2).astype(np.int32))),
        "stops.list.element.at": (truth["at"], *repeated(
            truth["stops_offs"], truth["stops_row"], at_def)),
        "stops.list.element.lat": (truth["lat"], *repeated(
            truth["stops_offs"], truth["stops_row"], lat_def)),
    }


NESTED_MAX_DEF = {"trip_id": 0, "pickup.ts": 1, "pickup.zone": 2,
                  "fees.key_value.key": 2, "fees.key_value.value": 3,
                  "stops.list.element.at": 3, "stops.list.element.lat": 4}


def check_nested_write(n_values: int, n_groups: int, dev, wrappers,
                       reps: int = 3) -> dict:
    """Phase 11a: the nested table written from ``DeviceValues`` on the
    card at 1 and the default encode workers and from numpy (all three
    files equal byte for byte), then read back with
    ``read_row_groups_device``: every value, level and mask equals the
    generator's.  Returns the launches of the card write and the read."""
    from tpuparquet_torch.format.metadata import CompressionCodec
    from tpuparquet_torch.io.reader import FileReader
    from tpuparquet_torch.io.writer import FileWriter
    from tpuparquet_torch.kernels.device import read_row_groups_device

    t0 = time.perf_counter()
    groups = build_nested(n_values, n_groups)
    on_card = [_nested_on_card(cols, dev) for cols, *_ in groups]
    _sync(dev)
    print(f"11a nested table: {n_groups} row groups of "
          f"{groups[0][4]['trip_id'].size} rows, built in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    def write(card: bool, threads=None) -> bytes:
        buf = io.BytesIO()
        with FileWriter(buf, NESTED_SCHEMA, codec=CompressionCodec.SNAPPY,
                        encode_threads=threads) as w:
            for i, (cols, masks, offs, elems, _) in enumerate(groups):
                w.write_columns(on_card[i] if card else cols, masks=masks,
                                offsets=offs, element_masks=elems)
        return buf.getvalue()

    launches = dict.fromkeys(wrappers, 0)
    for fn in wrappers.values():
        fn.launches = 0
    blob = write(True)
    _sync(dev)
    for k, fn in wrappers.items():
        launches[k] += fn.launches
    print(f"11a nested write from DeviceValues launches: "
          f"{dict(launches)}", flush=True)
    _need("11a nested write from DeviceValues", launches,
          ["lanes_min_max", "dict_build"])
    if write(True, 1) != blob or write(False) != blob \
            or write(False, 1) != blob:
        raise AssertionError("11a: the nested files from DeviceValues and "
                             "from numpy, at 1 and the default encode "
                             "workers, differ")
    reader = FileReader(blob)
    n_slots = sum(cc.meta_data.num_values for rg in reader.meta.row_groups
                  for cc in rg.columns)
    print(f"11a nested table: {len(blob)} bytes, {n_slots} level slots; "
          "the four files (DeviceValues and numpy, 1 and the default "
          "encode workers) are byte-equal", flush=True)
    for fn in wrappers.values():
        fn.launches = 0
    got = list(read_row_groups_device(reader, device=dev))
    _sync(dev)
    read_launches = {k: fn.launches for k, fn in wrappers.items()}
    print(f"11a nested read launches: {read_launches}", flush=True)
    _need("11a nested read", read_launches,
          ["unpack_u32", "expand_hybrid", "page_dict_fixed",
           "levels_to_validity"])
    for k, c in read_launches.items():
        launches[k] += c
    for (rg, out), (*_, truth) in zip(got, groups):
        for name, (vals, rep, dl) in _want_nested(truth).items():
            col = out[name]
            g_vals, g_rep, g_dl = col.to_numpy()
            if not _same_values(g_vals, vals):
                raise AssertionError(f"11a row group {rg} {name}: values")
            if not (np.array_equal(g_rep, rep) and np.array_equal(g_dl, dl)):
                raise AssertionError(f"11a row group {rg} {name}: levels")
            max_def = NESTED_MAX_DEF[name]
            if max_def and not np.array_equal(col.mask.cpu().numpy(),
                                              dl == max_def):
                raise AssertionError(f"11a row group {rg} {name}: mask")
    _same_as_cpu("11a nested table", reader, got)
    del got
    print("11a nested read: every value, rep and def level and mask "
          "equals the generator's; row group 0 equals the cpu run buffer "
          "for buffer", flush=True)
    for card, label in ((True, "DeviceValues"), (False, "numpy")):
        for threads in (None, 1):
            _best_write(f"11a nested write from {label} at "
                        f"{'the default' if threads is None else 1} "
                        "encode workers",
                        lambda: write(card, threads), n_slots, reps)
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        outs = [o for _, o in read_row_groups_device(reader, device=dev)]
        _sync(dev)
        best = min(best, time.perf_counter() - t0)
        del outs
    print(f"11a nested read best of {reps}: {best:.4f} s, "
          f"{n_slots / best:.4e} values/s", flush=True)
    return launches


def _connected(spans) -> None:
    """One tree a trace: every parent present, every span under a root."""
    ids = {s["span"] for s in spans}
    roots = {s["trace"] for s in spans if s["parent"] is None}
    for s in spans:
        if (s["parent"] is not None and s["parent"] not in ids) \
                or s["trace"] not in roots:
            raise AssertionError(f"span outside the tree: {s}")


def device_busy_share(fn):
    """Run ``fn()`` once under torch.profiler (CPU and CUDA activity) and
    return ``(busy s, wall s, top)``: the union of the device's kernel,
    copy and memset intervals inside the pass, the pass's own interval,
    both on the profiler's clock, and the device time of the six largest
    names (``[(name, s, count)]``); busy is None when the trace holds no
    device interval."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function("tpq_pass"):
            fn()
            torch.cuda.synchronize()
    events = prof.events()
    marks = [e for e in events if e.name == "tpq_pass"
             and e.device_type == DeviceType.CPU]
    if not marks:
        return None, None, []
    lo, hi = marks[0].time_range.start, marks[0].time_range.end
    # the record_function range has a device-side twin spanning the
    # pass's first to last device operation: not work, left out
    dev = [e for e in events if e.device_type == DeviceType.CUDA
           and e.name != "tpq_pass"
           and e.time_range.end > lo and e.time_range.start < hi]
    spans = sorted((max(e.time_range.start, lo), min(e.time_range.end, hi))
                   for e in dev)
    busy, end = 0.0, lo
    for a, b in spans:
        if b <= end:
            continue
        busy += b - max(a, end)
        end = b
    by_name: dict = {}
    for e in dev:
        t, c = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.time_range.end - e.time_range.start, c + 1)
    top = sorted(((n[:60], t / 1e6, c) for n, (t, c) in by_name.items()),
                 key=lambda x: -x[1])[:6]
    return (busy / 1e6 if spans else None), (hi - lo) / 1e6, top


def check_traced_pass(reader, dev, wrappers, n_values: int,
                      reps: int = 3) -> dict:
    """Phase 11b: config 2 read best of ``reps`` with tracing off, then
    with ``TPQ_TRACE`` on and ``collect_stats(events=True)``: one
    connected tree, ``plan`` spans = columns x row groups, ``unit``,
    ``transfer`` and ``dispatch`` spans = row groups, event-log pages =
    the ``pages`` counter = the page histograms' counts, the live
    registry's counters = the collector's, and the same launches as the
    untraced pass.  Then one traced pass under torch.profiler: the
    device busy share.  Returns the launches of one traced pass."""
    from tpuparquet_torch.kernels.device import read_row_groups_device
    from tpuparquet_torch.obs import live, trace
    from tpuparquet_torch.stats import collect_stats

    n_rg = reader.row_group_count()
    n_cols = len(reader.meta.row_groups[0].columns)

    def one(traced: bool, events: bool):
        with collect_stats(events=events) as st:
            t0 = time.perf_counter()
            if traced:
                with trace.trace_scope("pass"):
                    outs = [o for _, o in read_row_groups_device(
                        reader, device=dev)]
            else:
                outs = [o for _, o in read_row_groups_device(
                    reader, device=dev)]
            _sync(dev)
            dt = time.perf_counter() - t0
        del outs
        return dt, st

    prev = trace.tracer()
    try:
        trace.set_tracing(False)
        for fn in wrappers.values():
            fn.launches = 0
        one(False, False)
        plain_launches = {k: fn.launches for k, fn in wrappers.items()}
        off = min(one(False, False)[0] for _ in range(reps))
        trace.set_tracing(True)
        for fn in wrappers.values():
            fn.launches = 0
        live.reset_registry()
        _, st = one(True, True)
        launches = {k: fn.launches for k, fn in wrappers.items()}
        snap = live.registry().snapshot()
        spans = trace.snapshot_spans()
        on = min(one(True, True)[0] for _ in range(reps))
        busy = wall = None
        top = []
        if dev.type == "cuda":
            busy, wall, top = device_busy_share(lambda: one(True, True))
    finally:
        trace.set_tracing(prev is not None)
    _connected(spans)
    count = {}
    for s in spans:
        count[s["name"]] = count.get(s["name"], 0) + 1
    want = {"scan": 1, "unit": n_rg, "plan": n_cols * n_rg, "read":
            n_cols * n_rg, "transfer": n_rg, "dispatch": n_rg}
    if count != want:
        raise AssertionError(f"11b spans {count}, expected {want}")
    hists = st.histograms_dict()
    if not (len(st.events.pages) == st.pages
            == hists["page_comp_bytes"]["n"]
            == hists["page_uncomp_bytes"]["n"]
            and hists["stager_wave_us"]["n"] == n_rg):
        raise AssertionError(
            f"11b: {len(st.events.pages)} page events, pages "
            f"{st.pages}, histograms {hists}")
    counters = {k: v for k, v in st.to_state().items()
                if k not in ("hists", "wall_s") and v}
    if {k: snap["counters"].get(k) for k in counters} != counters \
            or snap["hists"] != hists:
        raise AssertionError(f"11b: registry {snap} differs from the "
                             f"collector's {counters}")
    if launches != plain_launches:
        raise AssertionError(f"11b: traced pass launched {launches}, the "
                             f"untraced one {plain_launches}")
    # the always-on cost: one registry fold a collect_stats scope or scan
    # unit (TPQ_LIVE_METRICS, on by default)
    reg = live.MetricsRegistry()
    t0 = time.perf_counter()
    for _ in range(100):
        live.fold_stats(st, reg)
    fold_us = (time.perf_counter() - t0) / 100 * 1e6
    _need("11b traced pass", launches, CONFIG2_KERNELS)
    print(f"11b traced pass: one connected tree, spans {count}; "
          f"{st.pages} page events = pages = histogram counts; registry "
          f"counters = the collector's; launches = the untraced pass's; "
          f"one live registry fold of the pass's collector {fold_us:.1f} us",
          flush=True)
    print(f"11b config 2 best of {reps}: tracing off {off:.4f} s, on with "
          f"events {on:.4f} s, ratio {on / off:.4f}; "
          f"{n_values / off:.4e} / {n_values / on:.4e} values/s",
          flush=True)
    if busy is None:
        print("11b device busy share: not measured (no device interval in "
              "the torch.profiler trace)", flush=True)
    else:
        print(f"11b device busy share of a traced pass under "
              f"torch.profiler: {busy:.6f} s of {wall:.6f} s = "
              f"{busy / wall:.4f} (union of kernels, copies and memsets); "
              f"largest device names (s, count): {top}", flush=True)
    return launches


def check_postmortem_scan(blob, mesh, dev, wrappers) -> dict:
    """Phase 11c: a quarantine-mode scan of config 2 with one corrupt page
    injected, ``postmortem=`` a path and ``TPQ_TRACE_EXPORT`` set: one
    incident a quarantined unit with a non-empty flight-recorder tail,
    and the exported trace loads with ``load_trace_file``.  Returns the
    launches."""
    from tpuparquet_torch.faults import inject_faults
    from tpuparquet_torch.obs import load_postmortem, load_trace_file, trace
    from tpuparquet_torch.shard import ShardedScan

    col = _column_paths(blob)[-1]
    for fn in wrappers.values():
        fn.launches = 0
    prev = trace.tracer()
    with tempfile.TemporaryDirectory(prefix=".smoke-", dir=os.path.dirname(
            os.path.abspath(__file__))) as tmp:
        pm = os.path.join(tmp, "scan.postmortem.json")
        tpath = os.path.join(tmp, "scan.trace.json")
        os.environ["TPQ_TRACE_EXPORT"] = tpath
        try:
            trace.set_tracing(True)
            with inject_faults() as inj:
                inj.inject("kernels.device.page_payload", "corrupt",
                           times=1, match={"column": col})
                s = ShardedScan([blob], mesh=mesh, on_error="quarantine",
                                retries=0, postmortem=pm)
                got = dict(s.run_iter())
            _sync(dev)
        finally:
            os.environ.pop("TPQ_TRACE_EXPORT", None)
            trace.set_tracing(prev is not None)
        doc = load_postmortem(pm)
        spans, _ = load_trace_file(tpath)
    n_q = len(s.quarantine)
    incidents = doc["incidents"]
    if n_q != 1 or len(incidents) != n_q or not all(
            i["recorder"] and i["trigger"]["kind"] == "quarantined"
            for i in incidents):
        raise AssertionError(f"11c: {n_q} quarantined, incidents "
                             f"{[i['trigger'] for i in incidents]}")
    _connected(spans)
    units = [sp for sp in spans if sp["name"] == "unit"]
    if len(units) != len(s.units) or sum(
            sp["status"] == "error" for sp in units) != n_q:
        raise AssertionError(f"11c: unit spans {units}")
    launches = {k: fn.launches for k, fn in wrappers.items()}
    print(f"11c quarantine scan: {len(got)} units decoded, {n_q} "
          f"quarantined; the post-mortem holds {len(incidents)} incident "
          f"({incidents[0]['trigger']['error']} on "
          f"{incidents[0]['trigger'].get('column')}, "
          f"{len(incidents[0]['recorder'])} recorder records); the "
          f"exported trace loads: {len(spans)} spans, one tree", flush=True)
    return launches


def _column_paths(blob) -> list:
    from tpuparquet_torch.io.reader import FileReader

    return [".".join(cc.meta_data.path_in_schema)
            for cc in FileReader(blob).meta.row_groups[0].columns]


def check_telemetry(blob, reader, mesh, dev, wrappers, n_values: int,
                    n_groups: int) -> dict:
    """Phase 11 (11a-11c); returns the launches of its paths."""
    t11 = time.perf_counter()
    total = dict.fromkeys(wrappers, 0)
    for launches in (
            check_nested_write(n_values, n_groups, dev, wrappers),
            check_traced_pass(reader, dev, wrappers, n_values),
            check_postmortem_scan(blob, mesh, dev, wrappers)):
        for k, c in launches.items():
            total[k] += c
    print(f"phase 11 (nested writes, traced pass, post-mortems): "
          f"{time.perf_counter() - t11:.2f} s", flush=True)
    return total


# ----------------------------------------------------------------------
# Phase 12: the telemetry's second part, every switch armed
# ----------------------------------------------------------------------

PHASE12_LABEL = "phase12"
# the objectives phase 12 writes into its SLO file: healthy scans of
# config 2 meet them, and one expired read among 16 units spends the
# error budget 6.25 times over
PHASE12_OBJECTIVES = [
    {"label": PHASE12_LABEL, "latency_stage": "unit", "latency_p": 0.99,
     "latency_target_ms": 30_000, "error_rate_target": 0.01,
     "window_s": 3600},
    {"label": PHASE12_LABEL, "latency_stage": "scan", "latency_p": 0.5,
     "latency_target_ms": 60_000, "window_s": 3600},
]


@contextlib.contextmanager
def _telemetry_switches():
    """Put tracing, the digests, the ring, the profiler and the alert
    engine back as they were (off, unless the environment armed them)
    when the block ends."""
    from tpuparquet_torch.obs import alerts, digest, profiler, timeseries, \
        trace

    saved = (trace.tracer(), digest.digests(), timeseries.ring(),
             profiler.profiler(), alerts.engine())
    try:
        yield
    finally:
        profiler.set_profiling(False)
        trace.set_tracing(saved[0] is not None)
        digest.set_digests(saved[1] is not None)
        timeseries.set_ring_dir(saved[2].dir if saved[2] else None)
        if saved[3] is not None:
            profiler.set_profiling(True, hz=saved[3].hz)
        alerts.set_engine(saved[4])


def _arm(ring_dir, objectives, alerts_path, hz):
    """Every switch on: tracing, the digests, the ring at ``ring_dir``,
    an alert engine with ``default_rules(objectives)`` recording to
    ``alerts_path`` and a fresh profiler at ``hz``; returns the
    profiler."""
    from tpuparquet_torch.obs import alerts, digest, profiler, timeseries, \
        trace

    trace.set_tracing(True)
    digest.set_digests(True)
    timeseries.set_ring_dir(ring_dir)
    alerts.set_engine(alerts.AlertEngine(alerts.default_rules(objectives),
                                         record_path=alerts_path))
    return profiler.set_profiling(True, hz=hz)


def _disarm() -> None:
    from tpuparquet_torch.obs import alerts, digest, profiler, timeseries, \
        trace

    profiler.set_profiling(False)
    trace.set_tracing(False)
    digest.set_digests(False)
    timeseries.set_ring_dir(None)
    alerts.set_engine(None)


def _timed_scan(path, mesh, dev, **kw):
    """``ShardedScan([path], ...).run()`` on the host clock to the card's
    fence: ``(scan, results, wall s)``."""
    from tpuparquet_torch.shard import ShardedScan

    scan = ShardedScan([path], mesh=mesh, **kw)
    t0 = time.perf_counter()
    results = scan.run()
    _sync(dev)
    return scan, results, time.perf_counter() - t0


def _profile_split(state) -> dict:
    """``{(label, stage): (samples, off-CPU samples)}`` of a profile
    state."""
    return {(lb, st): (b["samples"], b["offcpu"])
            for lb, sts in state["buckets"].items()
            for st, b in sts.items()}


def _stage_probe(kdevice, prof):
    """Patch ``kernels/device.py``'s ``_put_all`` (the transfer window) and
    ``levels_to_validity`` (called in the dispatch window) to take one
    hand-driven sample from a helper thread before running, so the
    calling thread is sampled inside each window; returns the undo."""
    put_all, levels = kdevice._put_all, kdevice.levels_to_validity

    def sample():
        t = threading.Thread(target=prof.sample_once)
        t.start()
        t.join(timeout=60)
        if t.is_alive():
            raise AssertionError("12e: a probe sample did not finish")

    def _transfer_probe(*a, **k):
        sample()
        return put_all(*a, **k)

    def _dispatch_probe(*a, **k):
        sample()
        return levels(*a, **k)

    kdevice._put_all, kdevice.levels_to_validity = (_transfer_probe,
                                                    _dispatch_probe)

    def undo():
        kdevice._put_all, kdevice.levels_to_validity = put_all, levels

    return undo


def check_armed_scan(blob, mesh, dev, wrappers, n_values: int,
                     want_staged: int | None = None, reps: int = 3) -> dict:
    """Phase 12: a ``ShardedScan`` of config 2 (from its path) with every
    switch of the telemetry armed: a progress file, the digests, the
    ring, the profiler at 500 Hz, tracing, an SLO file and an alert
    engine with its record file.  (a) the progress file's last frame is
    ``done`` with every unit, and its attribution's bytes equal the
    collector's (``bytes_read`` = the footers' chunk bytes,
    ``bytes_staged`` = the frame's and ``want_staged``, phase 3's);
    (b) the ledgers summed equal the registry's totals, exactly; (c) the
    ``unit`` digest counts every unit, the ``scan`` digest the run; (d)
    the ring's ``scan_end`` frame meets every objective, then a run
    whose first chunk read hangs 2 s under ``read_deadline=1`` fires the
    default rules' burn-rate alert into the record file; (e) the
    profile's split by label and stage, ``profile_consistency`` against
    the trace's stage seconds (no finding), the top frames of ``plan``,
    ``transfer`` and ``dispatch``, a hand-driven sample inside each
    transfer and dispatch window tagged with that stage, and the
    armed/off wall ratio at 50 and 500 Hz, best of ``reps``; (f) the main
    run launches config 2's kernels.  Returns every launch of the
    phase's passes."""
    from tpuparquet_torch.faults import inject_faults
    from tpuparquet_torch.io.reader import FileReader
    from tpuparquet_torch.kernels import device as kdevice
    from tpuparquet_torch.obs import alerts, attribution, digest, live, \
        profiler, slo, timeseries, trace
    from tpuparquet_torch.obs.progress import read_progress_file

    t12 = time.perf_counter()
    label = PHASE12_LABEL
    rgs = FileReader(blob).meta.row_groups
    chunk_bytes = sum(cc.meta_data.total_compressed_size for rg in rgs
                      for cc in rg.columns)
    _zero(wrappers)
    with tempfile.TemporaryDirectory(prefix=".smoke-", dir=os.path.dirname(
            os.path.abspath(__file__))) as tmp, _telemetry_switches():
        path = os.path.join(tmp, "config2.parquet")
        with open(path, "wb") as f:
            f.write(blob)
        ppath = os.path.join(tmp, "progress.json")
        ring_dir = os.path.join(tmp, "ring")
        slo_path = os.path.join(tmp, "slo.json")
        alerts_path = os.path.join(tmp, "alerts.json")
        with open(slo_path, "w") as f:
            json.dump(PHASE12_OBJECTIVES, f)
        objectives = slo.load_objectives(slo_path)

        # the main run
        live.reset_registry()
        attribution.reset_ledgers()
        prof = _arm(ring_dir, objectives, alerts_path, 500.0)
        scan, results, wall = _timed_scan(path, mesh, dev,
                                          progress_export=ppath,
                                          progress_label=label)
        launches = _launches_of(wrappers)
        profiler.set_profiling(False)
        state, brief = prof.to_state(), prof.brief()
        spans = trace.snapshot_spans()
        frame = read_progress_file(ppath)
        leds = attribution.ledgers_state()
        counters = live.registry().snapshot()["counters"]
        dstate = digest.digests().to_state()
        frames = timeseries.load_ring(ring_dir)
        sums = [unit_checksum(out) for out in results]
        del results

        # (a)
        n_units = len(scan.units)
        att = frame["attribution"]["bytes"]
        if (frame["state"], frame["units_done"], frame["units_total"],
                frame["rows_done"]) != ("done", n_units, n_units,
                                        sum(rg.num_rows for rg in rgs)):
            raise AssertionError(f"12a: last frame {frame}")
        staged = [att["staged"], frame["bytes_staged"],
                  counters["bytes_staged"]] + (
            [want_staged] if want_staged is not None else [])
        if att["read"] != chunk_bytes or len(set(staged)) != 1:
            raise AssertionError(f"12a: attribution bytes {att}, chunk "
                                 f"bytes {chunk_bytes}, staged {staged}")
        # (b)
        total: dict = {}
        for d in leds.values():
            for k, v in d["counters"].items():
                total[k] = total.get(k, 0) + v
        reg = {k: v for k, v in counters.items()
               if not k.startswith("profile_")}
        if total != reg or list(leds) != [label]:
            raise AssertionError(f"12b: ledgers {total} differ from the "
                                 f"registry's {reg}")
        # (c)
        unit_d = digest.QuantileDigest.from_dict(dstate[label]["unit"])
        scan_d = digest.QuantileDigest.from_dict(dstate[label]["scan"])
        if (unit_d.n, scan_d.n) != (n_units, 1):
            raise AssertionError(f"12c: digests of {unit_d.n} units and "
                                 f"{scan_d.n} runs, expected {n_units}, 1")
        # (d) the healthy run's frame
        report = slo.evaluate(frames, objectives)
        oks = [row[leg]["ok"] for row in report["objectives"]
               for leg in ("latency", "errors") if leg in row]
        if [f["kind"] for f in frames] != ["scan_end"] or oks != \
                [True] * len(oks):
            raise AssertionError(f"12d: frames {[f['kind'] for f in frames]}"
                                 f", report {report}")
        # (e) the profile against the trace's stage seconds
        root = [sp for sp in spans if sp["name"] == "scan"
                and sp.get("label") == label]
        if len(root) != 1:
            raise AssertionError(f"12e: {len(root)} scan roots")
        run_spans = [sp for sp in spans if sp["trace"] == root[0]["trace"]]
        stages_s = attribution.diagnose(run_spans)["stages_s"]
        findings = profiler.profile_consistency(state, stages_s)
        split = _profile_split(state)
        # the plan workers may starve the sampler of the GIL: the split
        # is printed, not held to a share
        if findings or not split:
            raise AssertionError(f"12e: profile {split}, findings "
                                 f"{findings}")
        # (f)
        _need("12f armed scan", launches, CONFIG2_KERNELS)

        # (d) a read that hangs past its deadline: the burn-rate alert
        prof_h = profiler.set_profiling(True, hz=500.0)
        with inject_faults() as inj:
            inj.inject("io.chunk.hang", "hang", times=1, seconds=2.0)
            scan_h, res_h, wall_h = _timed_scan(
                path, mesh, dev, progress_export=ppath,
                progress_label=label, read_deadline=1.0)
        profiler.set_profiling(False)
        sums_h = [unit_checksum(out) for out in res_h]
        del res_h
        led_h = attribution.ledgers_state()[label]["counters"]
        frames = timeseries.load_ring(ring_dir)
        firing = alerts.engine().evaluate(frames)
        record = alerts.load_alerts(alerts_path)["alerts"]
        burn = [a for a in record if a["kind"] == "burn_rate"]
        if sums_h != sums or led_h.get("deadline_exceeded") != 1 \
                or not burn or [f["kind"] for f in frames] != \
                ["scan_end"] * 2:
            raise AssertionError(
                f"12d: hung run: units equal {sums_h == sums}, "
                f"deadline_exceeded {led_h.get('deadline_exceeded')}, "
                f"alerts {record}, frames {len(frames)}")
        waits = {}
        for lb, sts in prof_h.to_state()["buckets"].items():
            for st, b in sts.items():
                for stack, c in b["stacks"].items():
                    if stack.endswith("[io-wait io.reader.chunk_read]"):
                        waits[st] = waits.get(st, 0) + c
        if not waits:
            raise AssertionError("12d: no io-wait sample of the hung read")
        report_h = slo.evaluate(frames, objectives)
        deadline_d = digest.digests().to_state().get(
            "deadline", {}).get("io.reader.chunk_read", {}).get("n")

        # (e) a hand-driven sample inside each transfer and dispatch window
        probe = profiler.set_profiling(True, start=False)
        undo = _stage_probe(kdevice, probe)
        try:
            scan_p, res_p, _ = _timed_scan(path, mesh, dev,
                                           progress_label=label)
        finally:
            undo()
            profiler.set_profiling(False)
        del res_p
        tags: dict = {}
        for lb, sts in probe.to_state()["buckets"].items():
            for st, b in sts.items():
                for stack, c in b["stacks"].items():
                    for name in ("_transfer_probe", "_dispatch_probe"):
                        if f":{name};" in stack:
                            key = (name, lb, st)
                            tags[key] = tags.get(key, 0) + c
        # one transfer window a unit; a dispatch window holds one K4
        # launch an optional column
        dispatch = tags.pop(("_dispatch_probe", label, "dispatch"), 0)
        if tags != {("_transfer_probe", label, "transfer"): n_units} \
                or dispatch < n_units or any(
                    k[0] == "_dispatch_probe" for k in tags):
            raise AssertionError(f"12e: probe samples {tags}, dispatch "
                                 f"{dispatch}")

        # (e) the armed/off wall ratio, best of reps, in turns
        best = {"off": float("inf"), 50.0: float("inf"),
                500.0: float("inf")}
        profiles = {50.0: [], 500.0: []}
        for _ in range(reps):
            for mode in best:
                if mode == "off":
                    _disarm()
                    kw = {}
                else:
                    armed = _arm(ring_dir, objectives, alerts_path, mode)
                    kw = {"progress_export": ppath}
                best[mode] = min(best[mode], _timed_scan(
                    path, mesh, dev, progress_label=label, **kw)[2])
                if mode != "off":
                    profiler.set_profiling(False)
                    profiles[mode].append(armed.to_state())
        _disarm()
    all_launches = _launches_of(wrappers)
    hz_period = state["period_s"]
    print(f"12 armed scan of config 2 ({n_units} units, 1x1 mesh, "
          f"{_plan_workers(None)} plan workers): {wall:.4f} s; launches "
          f"{launches}", flush=True)
    print(f"12a last progress frame: state {frame['state']}, units "
          f"{frame['units_done']}/{frame['units_total']}, rows "
          f"{frame['rows_done']}, attribution bytes {att} = the "
          f"collector's (read {chunk_bytes} chunk bytes, staged "
          f"{frame['bytes_staged']}"
          + (f", phase 3's {want_staged}" if want_staged is not None
             else "") + f"); cpu_s {frame['attribution']['cpu_s']}, "
          f"peak arena {frame['attribution']['peak_arena_bytes']} bytes",
          flush=True)
    print(f"12b ledgers summed = registry totals over {len(reg)} "
          "counters, exactly", flush=True)
    print(f"12c digests: unit n={unit_d.n} p50 < "
          f"{unit_d.quantile(0.5) / 1e3:.3f} ms, p95 < "
          f"{unit_d.quantile(0.95) / 1e3:.3f} ms, p99 < "
          f"{unit_d.quantile(0.99) / 1e3:.3f} ms; scan n={scan_d.n} < "
          f"{scan_d.quantile(0.5) / 1e3:.3f} ms", flush=True)
    print("12d healthy run: " + slo.format_report(report).replace(
        "\n", " |"), flush=True)
    print(f"12d hung run ({wall_h:.4f} s, first chunk read hung 2 s under "
          f"read_deadline=1): units equal the healthy run's, "
          f"deadline_exceeded 1, deadline digest n={deadline_d}, io-wait "
          f"samples by stage {waits}; alert record {len(record)} "
          f"({[(a['name'], a['kind']) for a in record]}), firing "
          f"{[a['name'] for a in firing]}; " + slo.format_report(
              report_h).replace("\n", " |"), flush=True)
    print(f"12e profile at {1 / hz_period:.0f} Hz ({brief['rate_hz']} "
          f"samples/s observed): samples "
          f"{state['counters']['profile_samples']}, off-CPU "
          f"{state['counters']['profile_samples_offcpu']}, drops "
          f"{state['counters']['profile_drops']}; by (label, stage) "
          f"(samples, off-CPU): {split}", flush=True)
    print(f"12e span stage seconds {stages_s}; sampled seconds "
          + str({st: round(sum(c for (_, s2), (c, _) in split.items()
                               if s2 == st) * hz_period, 4)
                 for st in sorted({s2 for _, s2 in split})})
          + f"; profile_consistency findings: {findings}", flush=True)
    for st in ("plan", "transfer", "dispatch"):
        top = profiler.top_frames(state, stage=st, n=10)
        print(f"12e top frames of {st}: "
              + json.dumps([(r["frame"], r["self"], r["share"])
                            for r in top]), flush=True)
    print(f"12e a hand-driven sample inside each window of the calling "
          f"thread: {n_units} in transfer windows tagged ({label!r}, "
          f"'transfer'), {dispatch} in dispatch windows tagged ({label!r}, "
          f"'dispatch')", flush=True)
    for hz, sts in profiles.items():
        merged = profiler.merge_profile_states(sts)
        c = merged["counters"]
        msplit = _profile_split(merged)
        print(f"12e profiles of the {len(sts)} armed runs at {hz:.0f} Hz: "
              f"samples {c['profile_samples']}, off-CPU "
              f"{c['profile_samples_offcpu']}, drops {c['profile_drops']};"
              f" by (label, stage): {msplit}; top frames of plan: "
              + json.dumps([(r["frame"], r["self"], r["share"]) for r in
                            profiler.top_frames(merged, stage="plan",
                                                n=6)]), flush=True)
    print(f"12e config 2 run() best of {reps}: all off {best['off']:.4f} s,"
          f" armed at 50 Hz {best[50.0]:.4f} s (ratio "
          f"{best[50.0] / best['off']:.4f}), at 500 Hz {best[500.0]:.4f} s "
          f"(ratio {best[500.0] / best['off']:.4f})", flush=True)
    print(f"phase 12 (progress, ledgers, digests, ring, profiler, SLOs, "
          f"alerts): {time.perf_counter() - t12:.2f} s", flush=True)
    return all_launches


# phase 13's tenants and their weights
PHASE13_TENANTS = (("light", 1.0), ("heavy", 3.0))


def check_native_writes(groups, dv_groups, n_values: int,
                        reps: int = 3) -> None:
    """Phase 5's native legs: config 2 from numpy (``groups``) and from
    DeviceValues (``dv_groups``) at one and the default encode workers,
    on the native page path and on the pure one (forced by a chunk
    resolving no native context), each written ``reps`` times in turns
    under a collector.  Every file must equal the first byte for byte;
    the native leg must assemble every data page natively
    (``pages_assembled_native`` = ``pages_written`` less the dictionary
    pages), the pure leg none.  Prints each leg's best wall and the native
    leg's stage seconds."""
    from tpuparquet_torch.io import chunk as io_chunk
    from tpuparquet_torch.io import pages as io_pages
    from tpuparquet_torch.io.reader import FileReader
    from tpuparquet_torch.stats import collect_stats

    t5 = time.perf_counter()
    native_ctx = io_pages._native_page_ctx
    legs = [(src, threads, native)
            for src in ("numpy", "DeviceValues") for threads in (1, None)
            for native in (True, False)]
    best = dict.fromkeys(legs, float("inf"))
    stats = {}
    first = None
    for _ in range(reps):
        for leg in legs:
            src, threads, native = leg
            io_chunk._native_page_ctx = io_pages._native_page_ctx = (
                native_ctx if native else (lambda codec: None))
            try:
                with collect_stats() as st:
                    t0 = time.perf_counter()
                    if src == "numpy":
                        out = _write(SCHEMA, groups, "payment_type",
                                     encode_threads=threads)
                    else:
                        out = _write(SCHEMA, dv_groups, None,
                                     encode_threads=threads)
                    wall = time.perf_counter() - t0
            finally:
                io_chunk._native_page_ctx = native_ctx
                io_pages._native_page_ctx = native_ctx
            if first is None:
                first = out
                n_dict = sum(cc.meta_data.dictionary_page_offset is not None
                             for rg in FileReader(out).meta.row_groups
                             for cc in rg.columns)
            elif out != first:
                raise AssertionError(f"5 native legs: {leg} wrote other "
                                     "bytes")
            want = st.pages_written - n_dict if native else 0
            if st.pages_assembled_native != want or want < 0:
                raise AssertionError(
                    f"5 native legs {leg}: {st.pages_assembled_native} "
                    f"pages assembled natively of {st.pages_written} "
                    f"({n_dict} dictionary pages), expected {want}")
            if wall < best[leg]:
                best[leg], stats[leg] = wall, st
    for leg in legs:
        src, threads, native = leg
        st = stats[leg]
        print(f"5 config 2 write from {src} at "
              f"{threads or 'the default'} encode workers, "
              f"{'native' if native else 'pure'} page path, "
              f"best of {reps} in turns: "
              f"{best[leg]:.4f} s, {n_values / best[leg]:.4e} values/s; "
              f"pages {st.pages_written}, {st.pages_assembled_native} "
              f"native; write_encode_s {st.write_encode_s:.4f}, "
              f"write_compress_s {st.write_compress_s:.4f}, "
              f"write_assemble_s {st.write_assemble_s:.4f}", flush=True)
    print(f"5 native legs: {len(legs)} files byte-equal "
          f"({len(first)} bytes, {n_dict} dictionary pages), "
          f"{time.perf_counter() - t5:.2f} s", flush=True)


def check_arbiter(blob, results, mesh, dev, wrappers,
                  reps: int = 3, walls: dict | None = None) -> dict:
    """Phase 13: the serve arbiter on the card.  A ``ResourceArbiter``
    over the usable CPUs with ``PHASE13_TENANTS`` is activated; two
    ``ShardedScan`` runs of config 2 (``blob``) go at once, each on its
    own thread under its ``tenant_scope``, where ``_plan_threads()`` and
    ``_write_threads()`` must equal the tenant's share.  The pair, its
    kernel counts set to 0 just before, must launch config 2's kernels,
    and each scan's units must equal ``results`` (6a's).  A full queue
    must be refused (``AdmissionRejected``, ``queue_full``, the tenant's
    last job wall as retry-after); after ``note_job_done`` and
    ``rebalance`` the shares are printed, then the pair's wall beside one
    unbound scan's, best of ``reps`` in turns (the pair's into
    ``walls["pair"]`` when ``walls`` is given).  Deactivated, the budgets
    must be what they were.  Returns the pair's launches."""
    from tpuparquet_torch import serve
    from tpuparquet_torch.errors import AdmissionRejected
    from tpuparquet_torch.io.writer import _write_threads
    from tpuparquet_torch.kernels.device import _plan_threads
    from tpuparquet_torch.shard import ShardedScan

    t13 = time.perf_counter()
    legacy = (_plan_threads(), _write_threads())
    arb = serve.ResourceArbiter(total_workers=len(os.sched_getaffinity(0)))
    for label, weight in PHASE13_TENANTS:
        arb.register(label, weight=weight)
    shares = arb.shares()
    print(f"13 arbiter: {arb.total_workers} workers, shares {shares}",
          flush=True)

    def scan_as(label, out):
        try:
            with serve.tenant_scope(label):
                out["threads"] = (_plan_threads(), _write_threads())
                t0 = time.perf_counter()
                out["results"] = ShardedScan([blob], mesh=mesh).run()
                _sync(dev)
                out["wall"] = time.perf_counter() - t0
        except BaseException as e:  # noqa: BLE001 - raised below
            out["error"] = e

    def pair():
        outs = {label: {} for label, _ in PHASE13_TENANTS}
        threads = [threading.Thread(target=scan_as, args=(lb, o))
                   for lb, o in outs.items()]
        t0 = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        wall = time.perf_counter() - t0
        for lb, o in outs.items():
            if "error" in o:
                raise AssertionError(f"13 {lb} scan failed") from o["error"]
        return outs, wall

    def alone():
        t0 = time.perf_counter()
        ShardedScan([blob], mesh=mesh).run()
        _sync(dev)
        return time.perf_counter() - t0

    serve.activate(arb)
    try:
        _zero(wrappers)
        outs, _ = pair()
        launches = _launches_of(wrappers)
        _need("13 arbiter pair", launches, CONFIG2_KERNELS)
        for lb, o in outs.items():
            want = (shares[lb], shares[lb])
            if o["threads"] != want:
                raise AssertionError(
                    f"13 {lb}: plan and write workers {o['threads']} "
                    f"inside its scope, its share is {shares[lb]}")
            _same_units(f"13 {lb} scan", dict(enumerate(o["results"])),
                        results)
            arb.note_job_done(lb, o["wall"])
        del outs
        try:
            arb.admit("light", queue_depth=8, queue_bound=8)
        except AdmissionRejected as e:
            if e.reason != "queue_full" or e.tenant != "light" \
                    or not e.retry_after_s > 0:
                raise AssertionError(f"13 admission: {e!r}") from e
            print(f"13 admission: a full queue refused ({e}), "
                  f"retry after {e.retry_after_s:.4f} s", flush=True)
        else:
            raise AssertionError("13 admission: a full queue admitted a "
                                 "job")
        arb.admit("heavy", est_bytes=len(blob))
        arb.release("heavy", len(blob))
        rebalanced = arb.rebalance()
        if sum(rebalanced.values()) != arb.total_workers \
                and arb.total_workers >= len(rebalanced):
            raise AssertionError(f"13 rebalance: shares {rebalanced}")
        print(f"13 rebalance: shares {rebalanced}; tenants "
              f"{json.dumps(arb.tenants_state(), sort_keys=True)}",
              flush=True)
        best_pair = best_alone = float("inf")
        for _ in range(reps):
            best_pair = min(best_pair, pair()[1])
            best_alone = min(best_alone, alone())
        if walls is not None:
            walls["pair"] = best_pair
        print(f"13 two tenants' scans at once, best of {reps} in turns: "
              f"{best_pair:.4f} s for the pair, {best_alone:.4f} s for one "
              f"unbound scan alone (ratio {best_pair / best_alone:.4f})",
              flush=True)
    finally:
        serve.deactivate(arb)
    after = (_plan_threads(), _write_threads())
    if after != legacy or serve.plan_budget() is not None:
        raise AssertionError(f"13: budgets {after} after the arbiter, "
                             f"{legacy} before")
    print(f"13: no arbiter active, plan and write workers {after} (the "
          f"legacy knobs); phase 13 {time.perf_counter() - t13:.2f} s",
          flush=True)
    return launches


# phase 14's emulated store (``EmulatedStoreSource`` knobs): a fixed
# latency a request, and a throttle (HTTP 429), a reset and a short
# response on every 7th, 11th and 13th request of a source
PHASE14_EMU = {"latency_ms": 2.0, "throttle_every": 7, "reset_every": 11,
               "short_every": 13}
# the same settings as the environment knobs a URI's source reads
PHASE14_EMU_KNOBS = {"TPQ_EMU_LATENCY_MS": "2.0", "TPQ_EMU_THROTTLE_EVERY": "7",
                     "TPQ_EMU_RESET_EVERY": "11", "TPQ_EMU_SHORT_EVERY": "13"}
# phase 14b's origin answers every 5th request with 429 and Retry-After
PHASE14_HTTP_THROTTLE = 5
PHASE14_RETRY_AFTER_S = 0.05


class ThrottlingOrigin(ThreadingHTTPServer):
    """Phase 14b's HTTP origin over a directory: ranged GETs and HEADs
    with an ETag, every ``throttle_every``-th request (counted over the
    server) answered 429 with ``Retry-After`` (the throttle of the repo's
    ``tools/httpfault.py`` fault server, kept here so this script needs
    nothing outside the port)."""

    daemon_threads = True

    def __init__(self, addr, root: str, throttle_every: int,
                 retry_after_s: float):
        super().__init__(addr, _OriginHandler)
        self.root = os.path.abspath(root)
        self.throttle_every = throttle_every
        self.retry_after_s = retry_after_s
        self._lock = threading.Lock()  # guards _requests
        self._requests = 0

    def next_request(self) -> int:
        with self._lock:
            self._requests += 1
            return self._requests

    @property
    def base_url(self) -> str:
        host, port = self.server_address[:2]
        return f"http://{host}:{port}"


class _OriginHandler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):
        pass

    def _object(self):
        """(path, size, etag) of the request's file, or None (404 sent)."""
        fs = os.path.abspath(os.path.join(
            self.server.root,
            urllib.parse.unquote(urllib.parse.urlsplit(self.path).path)
            .lstrip("/")))
        if not fs.startswith(self.server.root + os.sep) \
                or not os.path.isfile(fs):
            self.send_error(404, "no such object")
            return None
        st = os.stat(fs)
        tag = hashlib.sha1(f"{fs}|{st.st_size}|{st.st_mtime_ns}".encode())
        return fs, st.st_size, f'"{tag.hexdigest()[:20]}"'

    def _throttled(self) -> bool:
        n = self.server.next_request()
        if n % self.server.throttle_every:
            return False
        self.send_response(429)
        self.send_header("Retry-After", f"{self.server.retry_after_s:g}")
        self.send_header("Content-Length", "0")
        self.end_headers()
        return True

    def do_HEAD(self):
        obj = self._object()
        if obj is None or self._throttled():
            return
        _fs, size, etag = obj
        self.send_response(200)
        self.send_header("ETag", etag)
        self.send_header("Accept-Ranges", "bytes")
        self.send_header("Content-Length", str(size))
        self.end_headers()

    def do_GET(self):
        obj = self._object()
        if obj is None or self._throttled():
            return
        fs, size, etag = obj
        cond = self.headers.get("If-Match")
        if cond is not None and cond.strip() not in (etag, "*"):
            self.send_response(412)
            self.send_header("ETag", etag)
            self.send_header("Content-Length", "0")
            self.end_headers()
            return
        start, length, status = 0, size, 200
        hdr = self.headers.get("Range") or ""
        if hdr.startswith("bytes="):
            first, _, last = hdr[6:].split(",")[0].strip().partition("-")
            if first:
                start = int(first)
                end = min(int(last) if last else size - 1, size - 1)
            else:
                start, end = max(0, size - int(last)), size - 1
            if start >= size or end < start:
                self.send_response(416)
                self.send_header("Content-Range", f"bytes */{size}")
                self.send_header("Content-Length", "0")
                self.end_headers()
                return
            length, status = end - start + 1, 206
        self.send_response(status)
        self.send_header("ETag", etag)
        self.send_header("Accept-Ranges", "bytes")
        self.send_header("Content-Length", str(length))
        if status == 206:
            self.send_header("Content-Range",
                             f"bytes {start}-{start + length - 1}/{size}")
        self.end_headers()
        with open(fs, "rb") as f:
            f.seek(start)
            self.wfile.write(f.read(length))
# phase 14d's hive partitions, config 2's row groups two a partition, and
# the two its filter keeps
PHASE14_REGIONS = ("ap", "eu", "sa", "us")
PHASE14_KEEP = ("eu", "us")
REMOTE_COUNTERS = ("remote_ranges_fetched", "ranges_coalesced",
                   "remote_bytes", "remote_retry", "cache_hits_mem",
                   "cache_misses_mem", "cache_hits_disk",
                   "cache_misses_disk", "cache_evictions_disk")


def _emu_faults(first: int, last: int, knobs: dict) -> int:
    """How many of an emulated source's requests ``first..last`` fail (a
    throttle, a reset or a short response: each one a retry)."""
    every = [knobs[k] for k in ("throttle_every", "reset_every",
                                "short_every") if knobs.get(k)]
    return sum(1 for n in range(first, last + 1)
               if any(n % e == 0 for e in every))


def _chunk_spans(reader) -> tuple:
    """``(chunks, spans, span bytes)`` of a pass that prefetches each row
    group's chunk ranges coalesced under ``TPQ_RANGE_COALESCE_GAP``."""
    from tpuparquet_torch.io.source import coalesce_gap_default, \
        coalesce_ranges

    n = n_spans = span_bytes = 0
    for rg in reader.meta.row_groups:
        ranges = [(reader._chunk_start(cm), cm.total_compressed_size)
                  for _p, _n, cm in reader.selected_chunks(rg)]
        spans = coalesce_ranges(ranges, coalesce_gap_default())
        n += len(ranges)
        n_spans += len(spans)
        span_bytes += sum(z for _s, z, _m in spans)
    return n, n_spans, span_bytes


def _row_group_pass(reader, dev, wrappers):
    """Every row group of ``reader``, one ``read_row_group_device`` call
    each (a source's chunk ranges prefetched into the disk tier first),
    the kernel counts set to 0 just before.  Returns ``(outputs,
    launches, collector, wall)``."""
    from tpuparquet_torch.kernels.device import read_row_group_device
    from tpuparquet_torch.stats import collect_stats

    for fn in wrappers.values():
        fn.launches = 0
    t0 = time.perf_counter()
    with collect_stats() as st:
        got = [(i, read_row_group_device(reader, i, device=dev))
               for i in range(reader.row_group_count())]
        _sync(dev)
    wall = time.perf_counter() - t0
    _no_ladder("a remote read", st)
    return got, {k: fn.launches for k, fn in wrappers.items()}, st, wall


def _counters(st) -> dict:
    return {k: getattr(st, k) for k in REMOTE_COUNTERS}


def _fresh_tier(cache: str) -> None:
    """An empty disk tier in ``cache`` and no tier singletons."""
    import shutil

    from tpuparquet_torch.io.rangecache import reset_range_caches

    shutil.rmtree(cache, ignore_errors=True)
    os.makedirs(cache)
    reset_range_caches()


def _check_cold_warm(label, open_reader, faults_of, want, dev, wrappers,
                     threads, cache) -> dict:
    """A cold pass (an empty tier), then a warm one (a new reader over
    the filled tier), at ``threads`` plan workers.  Cold: the buffers are
    ``want``'s, every chunk range is fetched in one coalesced span or
    saved by one (``remote_ranges_fetched + ranges_coalesced`` = the
    chunks, ``remote_bytes`` = the spans' bytes), ``remote_retry`` = the
    faults ``faults_of(reader, before)`` counts, and every chunk read
    hits the disk tier.  Warm: no fetch, a disk hit a chunk.  Returns
    the walls and counters."""
    out = {}
    _fresh_tier(cache)
    with _plan_threads_env(threads):
        for leg in ("cold", "warm"):
            reader = open_reader()  # the footer's reads outside the pass
            before = faults_of(reader, None)
            got, launches, st, wall = _row_group_pass(reader, dev,
                                                      wrappers)
            faults = faults_of(reader, before)
            n, n_spans, span_bytes = _chunk_spans(reader)
            reader.close()
            _same_columns(f"{label} {leg}", got, want)
            del got
            c = _counters(st)
            bad = []
            if leg == "cold":
                if c["remote_ranges_fetched"] + c["ranges_coalesced"] != n:
                    bad.append(f"fetched + coalesced != {n} chunks")
                if c["remote_ranges_fetched"] != n_spans:
                    bad.append(f"fetched != {n_spans} spans")
                if c["remote_bytes"] != span_bytes:
                    bad.append(f"remote_bytes != {span_bytes}")
                if c["remote_retry"] != faults:
                    bad.append(f"remote_retry != {faults} faults")
            elif c["remote_ranges_fetched"] or c["remote_retry"]:
                bad.append("a warm pass fetched")
            if c["cache_hits_disk"] != n or c["cache_misses_disk"]:
                bad.append(f"disk hits != {n} chunks")
            if bad:
                raise AssertionError(f"{label} {leg}: {bad}: {c}")
            _need(f"{label} {leg}", launches, CONFIG2_KERNELS)
            out[leg] = (wall, c, launches)
            print(f"{label} {leg} at {_plan_workers(threads)} plan "
                  f"workers: {wall:.4f} s; {c}; injected faults "
                  f"{faults}", flush=True)
    return out


def _add(total, launches) -> None:
    for k, c in launches.items():
        total[k] = total.get(k, 0) + c


def remote_child(argv) -> int:
    """One process of phase 14c (``chip_smoke.py --remote-child OUT URI
    KNOBS DEVICE``): reads URI row group by row group on DEVICE
    (``cuda``: this process's card) through the process's range caches
    (the ``TPQ_CACHE_*`` environment), the footer read before the pass,
    and writes to OUT each row group's checksum, the pass's remote and
    cache counters, and the faults its emulated source (knobs: the JSON
    KNOBS) fired in the pass."""
    out, uri, knobs, device = argv
    if device == "cuda" and not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from tpuparquet_torch.io.reader import FileReader
    from tpuparquet_torch.io.source import EmulatedStoreSource, \
        parse_source_uri

    knobs = json.loads(knobs)
    dev = torch.device(device, 0) if device == "cuda" \
        else torch.device(device)
    src = EmulatedStoreSource(parse_source_uri(uri)[1], uri, **knobs)
    reader = FileReader(src)
    first = src._requests + 1
    got, _launches, st, wall = _row_group_pass(reader, dev, {})
    faults = _emu_faults(first, src._requests, knobs)
    sums = [unit_checksum(cols) for _i, cols in got]
    reader.close()
    with open(out, "w") as f:
        json.dump({"checksums": sums, "counters": _counters(st),
                   "faults": faults, "wall": wall}, f)
    return 0


def _shared_pair(uri: str, cache: str, tmp: str, dev) -> list:
    """Phase 14c's two processes on ``dev``'s type, started at once over
    one shared disk tier; each has 300 s, and both are killed past
    it."""
    env = dict(os.environ, TPQ_CACHE_DISK_DIR=cache,
               TPQ_CACHE_DISK_SHARED="1")
    outs = [os.path.join(tmp, f"shared{r}.json") for r in (0, 1)]
    logs = [os.path.join(tmp, f"shared{r}.log") for r in (0, 1)]
    procs = []
    try:
        for r in (0, 1):
            with open(logs[r], "w") as log:
                procs.append(subprocess.Popen(
                    [sys.executable, os.path.abspath(__file__),
                     "--remote-child", outs[r], uri,
                     json.dumps(PHASE14_EMU), dev.type], env=env,
                    stdout=log,
                    stderr=subprocess.STDOUT))
        deadline = time.monotonic() + 300
        while any(p.poll() is None for p in procs) \
                and time.monotonic() < deadline:
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    if any(p.returncode != 0 for p in procs):
        tails = []
        for r, p in enumerate(procs):
            with open(logs[r]) as f:
                tails.append(f"process {r} (exit {p.returncode}):\n"
                             f"{f.read()[-3000:]}")
        raise AssertionError("14c: a process failed\n" + "\n".join(tails))
    found = []
    for o in outs:
        with open(o) as f:
            found.append(json.load(f))
    return found


def check_remote(blob, groups, reader, mesh, dev, wrappers,
                 c2_pass_s: float) -> dict:
    """Phase 14: config 2 read through the byte-range sources and the
    range caches, and a partitioned dataset scanned through
    ``DatasetScan``.  Returns the launches of its main-path reads."""
    import glob

    from tpuparquet_torch import DatasetScan, ShardedScan, col
    from tpuparquet_torch.dataset.manifest import partition_dir
    from tpuparquet_torch.io.reader import FileReader
    from tpuparquet_torch.io.source import EmulatedStoreSource, \
        HttpByteRangeSource
    from tpuparquet_torch.stats import collect_stats

    t14 = time.perf_counter()
    total: dict = {}
    want, launches, _st, local_s = _row_group_pass(reader, dev, wrappers)
    _need("14 local", launches, CONFIG2_KERNELS)
    _add(total, launches)
    with tempfile.TemporaryDirectory(
            prefix=".smoke-", dir=os.path.dirname(
                os.path.abspath(__file__))) as tmp:
        path = os.path.join(tmp, "config2.parquet")
        with open(path, "wb") as f:
            f.write(blob)
        cache = os.path.join(tmp, "cache")
        with FileReader(path) as r:
            _g, _l, _s, path_s = _row_group_pass(r, dev, wrappers)
        del _g
        print(f"14 local: phase 3's pass {c2_pass_s:.4f} s "
              "(read_row_groups_device, in memory); one "
              f"read_row_group_device a row group {local_s:.4f} s in "
              f"memory, {path_s:.4f} s from its path", flush=True)

        # 14a: emu://, cold then warm, at the default and 1 plan worker
        def open_emu():
            return FileReader(EmulatedStoreSource(
                path, "emu://" + path, **PHASE14_EMU))

        def emu_faults(r, before):
            n = r._source._requests
            return n + 1 if before is None else _emu_faults(before, n,
                                                            PHASE14_EMU)

        walls = {}
        with _env(TPQ_CACHE_DISK_DIR=cache, TPQ_CACHE_DISK_MB=None,
                  TPQ_CACHE_DISK_SHARED=None):
            for threads in (None, 1):
                got = _check_cold_warm("14a emu", open_emu, emu_faults,
                                       want, dev, wrappers, threads, cache)
                for leg, (wall, _c, launches) in got.items():
                    walls[("emu", leg, _plan_workers(threads))] = wall
                    _add(total, launches)

            # 14b: http:// from an origin on 127.0.0.1 that throttles
            srv = ThrottlingOrigin(("127.0.0.1", 0), tmp,
                                   PHASE14_HTTP_THROTTLE,
                                   PHASE14_RETRY_AFTER_S)
            th = threading.Thread(target=srv.serve_forever, daemon=True)
            th.start()
            try:
                url = f"{srv.base_url}/config2.parquet"

                def open_http():
                    return FileReader(HttpByteRangeSource(url))

                def http_faults(_r, before):
                    n = srv._requests
                    return n + 1 if before is None else sum(
                        1 for k in range(before, n + 1)
                        if k % PHASE14_HTTP_THROTTLE == 0)

                for threads in (None, 1):
                    got = _check_cold_warm("14b http", open_http,
                                           http_faults, want, dev,
                                           wrappers, threads, cache)
                    if got["cold"][1]["remote_retry"] < 1:
                        raise AssertionError("14b: no 429 retried")
                    for leg, (wall, _c, launches) in got.items():
                        walls[("http", leg, _plan_workers(threads))] = wall
                        _add(total, launches)
            finally:
                srv.shutdown()
                srv.server_close()
                th.join(10.0)
        print(f"14a/14b walls (s): {walls}; every 429 carried "
              f"Retry-After {PHASE14_RETRY_AFTER_S} s", flush=True)

        # 14c: two processes at once over one shared disk tier
        _fresh_tier(cache)
        t0 = time.perf_counter()
        found = _shared_pair("emu://" + path, cache, tmp, dev)
        pair_s = time.perf_counter() - t0
        n = _chunk_spans(reader)[0]
        sums = [unit_checksum(cols) for _i, cols in want]
        fleet = {k: sum(f["counters"][k] for f in found)
                 for k in REMOTE_COUNTERS}
        asked = fleet["remote_ranges_fetched"] + fleet["ranges_coalesced"]
        bad = []
        if any(f["checksums"] != sums for f in found):
            bad.append("a process's buffers differ from the local read's")
        if fleet["cache_hits_disk"] != 2 * n or fleet["cache_misses_disk"] \
                or fleet["cache_evictions_disk"]:
            bad.append(f"disk hits != 2 x {n} chunks, or a miss or an "
                       "eviction")
        if not n <= asked <= 2 * n:
            bad.append(f"{asked} chunk ranges asked of the store, not "
                       f"{n}-{2 * n}")
        if fleet["remote_retry"] != sum(f["faults"] for f in found):
            bad.append("remote_retry != the injected faults")
        entries = glob.glob(os.path.join(cache, "*.tpqc"))
        if len(entries) != n or os.path.exists(
                os.path.join(cache, "index.lock")):
            bad.append(f"{len(entries)} entries (not {n}) or a lock left")
        if bad:
            raise AssertionError(f"14c: {bad}: fleet {fleet}")
        print(f"14c shared disk tier, two processes at once: {pair_s:.2f} "
              f"s with their start; fleet {fleet}; the processes' passes "
              f"{[round(f['wall'], 4) for f in found]} s; {len(entries)} "
              "entries, no lock left", flush=True)

        # 14d: DatasetScan over four hive partitions on an emu:// root
        root = os.path.join(tmp, "trips")
        g2 = [(c, {"payment_type": m}) for c, m in groups]
        per = len(groups) // len(PHASE14_REGIONS)
        kept = []
        for i, region in enumerate(PHASE14_REGIONS):
            d = os.path.join(root, partition_dir(["region"],
                                                 {"region": region}))
            os.makedirs(d)
            part = groups[i * per:(i + 1) * per]
            with open(os.path.join(d, "part-0.parquet"), "wb") as f:
                f.write(_write(SCHEMA, part, "payment_type"))
            if region in PHASE14_KEEP:
                kept += g2[i * per:(i + 1) * per]
        f_keep = col("region").isin(list(PHASE14_KEEP))
        fixed = list(groups[0][0])
        with _env(TPQ_CACHE_DISK_DIR=None):
            with collect_stats() as st:
                ds = DatasetScan("emu://" + root, mesh=mesh, filter=f_keep)
            for fn in wrappers.values():
                fn.launches = 0
            t0 = time.perf_counter()
            results = ds.run()
            gathered = {name: ds.gather_column(results, name)
                        for name in fixed}
            placed = {name: ds.gather_column(
                results, name, gather_to=0 if dev.type == "cuda" else dev)
                for name in fixed}
            _sync(dev)
            ds_s = time.perf_counter() - t0
            launches = {k: fn.launches for k, fn in wrappers.items()}
            with ShardedScan(ds.sources, mesh=mesh) as plain:
                plain_units = plain.run()
            ds.close()
        if st.dataset_files_pruned != 2 or ds.files_pruned != 2:
            raise AssertionError(f"14d: {st.dataset_files_pruned} files "
                                 "pruned, not 2")
        if sorted(p["region"] for p in ds.partitions.values()) != \
                sorted(PHASE14_KEEP):
            raise AssertionError(f"14d: partitions {ds.partitions}")
        _same_columns("14d units", list(enumerate(results)),
                      list(enumerate(plain_units)))
        for name in fixed:
            _check_fixed_gather("14d", name, gathered[name], kept, results)
            _same_gather("14d", name, placed[name], gathered[name],
                         "to device 0")
        _need("14d", launches, CONFIG2_KERNELS + ["scatter_to_dense",
                                                  "place_rows"])
        _add(total, launches)
        print(f"14d DatasetScan of {ds.sources}: {len(results)} units, "
              f"dataset_files_pruned {st.dataset_files_pruned}, run() and "
              f"{2 * len(fixed)} gathers (replicated, to device 0) "
              f"{ds_s:.4f} s; units equal a ShardedScan of the "
              "survivors', gathers the generator's; "
              f"launches {launches}", flush=True)
    print(f"phase 14 (remote sources, range caches, DatasetScan): "
          f"{time.perf_counter() - t14:.2f} s", flush=True)
    return total


# phase 15's plan-cache budget (MB) and the seconds a job may take
PHASE15_PLAN_CACHE_MB = 256
PHASE15_JOB_S = 600.0


def _server(mesh, **kw):
    """A ``ScanServer`` over the usable CPUs on ``mesh`` with phase 13's
    tenants."""
    from tpuparquet_torch.serve import ResourceArbiter, ScanServer

    srv = ScanServer(arbiter=ResourceArbiter(
        total_workers=len(os.sched_getaffinity(0))), mesh=mesh, **kw)
    for label, weight in PHASE13_TENANTS:
        srv.add_tenant(label, weight=weight)
    return srv


def _done(label, jobs) -> None:
    """Every job of ``jobs`` ended ``done`` within the phase's time."""
    for job in jobs:
        if not job.wait(PHASE15_JOB_S) or job.state != "done":
            raise AssertionError(f"{label}: job {job.as_dict()}") \
                from job.error


def _tenant_jobs(path, mesh, dev, per_tenant: int):
    """``per_tenant`` jobs a tenant of phase 13 over ``path`` through one
    server, all submitted at once; ``(jobs, wall, status)``."""
    # a rebalance every 0.25 s, so the tenants' ledgers feed the shares
    # while the jobs run
    srv = _server(mesh, rebalance_interval=0.25)
    try:
        t0 = time.perf_counter()
        jobs = [srv.submit(label, [path], job_id=f"{label}-{i}")
                for i in range(per_tenant) for label, _ in PHASE13_TENANTS]
        _done("15a", jobs)
        _sync(dev)
        wall = time.perf_counter() - t0
        status = srv.status()
    finally:
        srv.shutdown()
    return jobs, wall, status


def check_server_pair(path, results, mesh, dev, wrappers, pair13_s,
                      reps: int = 3) -> dict:
    """Phase 15a (see the module docstring); returns its launches."""
    from tpuparquet_torch.obs import attribution, live

    live.reset_registry()
    attribution.reset_ledgers()
    _zero(wrappers)
    jobs, wall, status = _tenant_jobs(path, mesh, dev, 2)
    launches = _launches_of(wrappers)
    _need("15a server jobs", launches, CONFIG2_KERNELS)
    for job in jobs:
        _same_units(f"15a {job.tenant}/{job.job_id}", job.outputs, results)
        if job.units_done != len(results) or job.units_quarantined:
            raise AssertionError(f"15a: {job.as_dict()}")
    leds = attribution.ledgers_state()
    counters = live.registry().snapshot()["counters"]
    total: dict = {}
    for d in leds.values():
        for k, v in d["counters"].items():
            total[k] = total.get(k, 0) + v
    # the registry's scope wall is no ledger counter
    reg = {k: v for k, v in counters.items()
           if not k.startswith("profile_") and k != "wall_s"}
    if total != reg or sorted(leds) != sorted(
            lb for lb, _ in PHASE13_TENANTS):
        raise AssertionError(f"15a: ledgers {sorted(leds)} summed {total} "
                             f"differ from the registry's {reg}")
    for label, _ in PHASE13_TENANTS:
        rgs = leds[label]["counters"]["row_groups"]
        if rgs != 2 * len(results):
            raise AssertionError(f"15a: {label}'s ledger counts {rgs} row "
                                 f"groups, not {2 * len(results)}")
    del jobs
    print(f"15a two jobs a tenant through a ScanServer: {wall:.4f} s, "
          f"every unit 6a's; ledgers {sorted(leds)} sum to the registry; "
          f"launches {launches}; status "
          f"{json.dumps(status, sort_keys=True)}", flush=True)
    best = float("inf")
    for _ in range(reps):
        jobs, wall, _status = _tenant_jobs(path, mesh, dev, 1)
        del jobs
        best = min(best, wall)
    beside = ("" if pair13_s is None else
              f"; phase 13's thread pair {pair13_s:.4f} s (ratio "
              f"{best / pair13_s:.4f})")
    print(f"15a one job a tenant at once through the server, best of "
          f"{reps}: {best:.4f} s{beside}", flush=True)
    return launches


def check_drain_resume(path, results, mesh, dev, wrappers, tmp) -> dict:
    """Phase 15b (see the module docstring); returns its launches."""
    state = os.path.join(tmp, "state")
    decodes: dict = {}
    outs: dict = {}
    box: dict = {}

    def sink_for(job_id):
        def sink(k, out):
            decodes[(job_id, k)] = decodes.get((job_id, k), 0) + 1
            outs[(job_id, k)] = out
            if "asked" not in box:
                box["asked"] = True
                box["srv"].request_drain()  # once the first unit lands
        return sink

    def submit_all(srv):
        return [srv.submit("light", [path], job_id=job_id,
                           checkpoint_every=1, sink=sink_for(job_id))
                for job_id in ("a", "b")]

    _zero(wrappers)
    srv = box["srv"] = _server(mesh, state_dir=state)
    try:
        first = submit_all(srv)
        if not first[0].wait(PHASE15_JOB_S):
            raise AssertionError("15b: the running job did not stop")
    finally:
        srv.shutdown(timeout=PHASE15_JOB_S)
    got = [(j.state, j.units_done) for j in first]
    if got != [("drained", 1), ("drained", 0)]:
        raise AssertionError(f"15b: after the drain {got}, expected the "
                             "running job drained after its first unit "
                             "and the queued one drained untouched")
    cursors = sorted(os.listdir(state))
    srv = _server(mesh, state_dir=state)
    try:
        second = submit_all(srv)
        _done("15b successor", second)
    finally:
        srv.shutdown()
    launches = _launches_of(wrappers)
    _need("15b drain and resume", launches, CONFIG2_KERNELS)
    for job_id in ("a", "b"):
        keys = sorted(k for j, k in outs if j == job_id)
        if keys != list(range(len(results))):
            raise AssertionError(f"15b {job_id}: units {keys}")
        _same_units(f"15b {job_id}", {k: outs[(job_id, k)] for k in keys},
                    results)
    if set(decodes.values()) != {1}:
        raise AssertionError(f"15b: a unit decoded twice: {decodes}")
    del outs
    print(f"15b drain after the first unit: {got} (cursors {cursors}); "
          f"the successor resumed both to done, the union 6a's units, "
          f"each decoded once; launches {launches}", flush=True)
    return launches


def _spread(walls) -> str:
    """Walls as ``median [min, max]``."""
    w = sorted(walls)
    return f"{w[len(w) // 2]:.4f} [{w[0]:.4f}, {w[-1]:.4f}]"


def check_server_prefetch(path, results, reader, mesh, dev, wrappers,
                          tmp, rounds: int = 3) -> dict:
    """Phase 15c (see the module docstring), ``rounds`` rounds of the two
    depths in turns; returns its launches."""
    cache = os.path.join(tmp, "cache")
    n, n_spans, span_bytes = _chunk_spans(reader)
    # phase 14's emulator knobs, as the sources a URI opens read them
    knobs = dict(PHASE14_EMU_KNOBS)
    want = {"remote_ranges_fetched": n_spans, "ranges_coalesced": n - n_spans,
            "remote_bytes": span_bytes, "cache_hits_disk": n,
            "cache_misses_disk": 0, "cache_evictions_disk": 0}
    total: dict = {}
    walls: dict = {"0": [], "default": []}
    for _ in range(rounds):
        for depth in ("0", None):
            label = f"15c emu:// prefetch depth {depth or 'default'}"
            _fresh_tier(cache)
            with _env(TPQ_CACHE_DISK_DIR=cache, TPQ_CACHE_DISK_MB=None,
                      TPQ_CACHE_DISK_SHARED=None, TPQ_PREFETCH_DEPTH=depth,
                      **knobs):
                _zero(wrappers)
                srv = _server(mesh)
                try:
                    t0 = time.perf_counter()
                    job = srv.submit("light", ["emu://" + path])
                    _done(label, [job])
                    _sync(dev)
                    wall = time.perf_counter() - t0
                finally:
                    srv.shutdown()
            launches = _launches_of(wrappers)
            _need(label, launches, CONFIG2_KERNELS)
            _add(total, launches)
            _same_units(label, job.outputs, results)
            c = _counters(job.stats)
            if {k: c[k] for k in want} != want:
                raise AssertionError(f"{label}: counters {c}, expected "
                                     f"{want}")
            walls[depth or "default"].append(wall)
            del job
    print(f"15c emu:// through the server, cold, {rounds} rounds in turns, "
          f"every job's counters {want} (remote_retry "
          f"{c['remote_retry']}): wall at TPQ_PREFETCH_DEPTH=0 "
          f"{_spread(walls['0'])} s, at the default "
          f"{_spread(walls['default'])} s (median [min, max])", flush=True)
    return total


def check_server_plan_cache(path, results, reader, mesh, dev, wrappers,
                            rounds: int = 3) -> dict:
    """Phase 15d (see the module docstring), ``rounds`` rounds of a cold
    and a warm job from an empty cache; returns its launches."""
    from tpuparquet_torch.kernels.plancache import clear_plan_cache

    n = _chunk_count(reader)
    walls: dict = {"cold": [], "warm": []}
    plan: dict = {"cold": [], "warm": []}
    _zero(wrappers)
    for r in range(rounds):
        clear_plan_cache()
        srv = _server(mesh, plan_cache_mb=PHASE15_PLAN_CACHE_MB)
        jobs = []
        try:
            for leg in ("cold", "warm"):
                t0 = time.perf_counter()
                job = srv.submit("light", [path], job_id=f"{leg}-{r}")
                _done("15d", [job])
                _sync(dev)
                walls[leg].append(time.perf_counter() - t0)
                plan[leg].append(job.stats.plan_s)
                jobs.append(job)
        finally:
            srv.shutdown()
            clear_plan_cache()
        got = [(j.stats.plan_cache_hits, j.stats.plan_cache_misses)
               for j in jobs]
        if got != [(0, n), (n, 0)] or jobs[1].stats.chunks != n:
            raise AssertionError(f"15d: plan cache (hits, misses) {got}, "
                                 f"expected {[(0, n), (n, 0)]}")
        for j in jobs:
            _same_units(f"15d {j.job_id}", j.outputs, results)
        del jobs
    launches = _launches_of(wrappers)
    _need("15d plan cache", launches, CONFIG2_KERNELS)
    print(f"15d plan cache of {PHASE15_PLAN_CACHE_MB} MB, {rounds} rounds "
          f"from an empty cache: the warm job hit {n} of {n} chunks each "
          f"round; walls cold {_spread(walls['cold'])} s, warm "
          f"{_spread(walls['warm'])} s; plan_s cold "
          f"{_spread(plan['cold'])}, warm {_spread(plan['warm'])} "
          f"(median [min, max])", flush=True)
    return launches


def _tool(*argv) -> tuple:
    """``parquet_tool.main(argv)`` in this process: ``(rc, stdout)``."""
    from tpuparquet_torch.cli import parquet_tool

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = parquet_tool.main(list(argv))
    return rc, out.getvalue()


def check_tool(path, results, dev, wrappers, tmp) -> dict:
    """Phase 15e (see the module docstring); returns its launches."""
    import signal

    device = "cuda" if dev.type == "cuda" else str(dev)
    total: dict = {}
    _zero(wrappers)
    t0 = time.perf_counter()
    rc, out = _tool("verify", "--device", device, path)
    verify_s = time.perf_counter() - t0
    launches = _launches_of(wrappers)
    if rc != 0 or "all row groups bit-exact" not in out:
        raise AssertionError(f"15e verify exited {rc}:\n{out}")
    _need("15e verify", launches, CONFIG2_KERNELS)
    _add(total, launches)
    print(f"15e parquet_tool verify ({verify_s:.2f} s, the host decode "
          f"included): exit 0; launches {launches}\n{out.rstrip()}",
          flush=True)

    root = os.path.join(tmp, "serve")
    spec = {"status_export": os.path.join(root, "status.json"),
            "state_dir": os.path.join(root, "state"),
            "tenants": [{"label": lb, "weight": w}
                        for lb, w in PHASE13_TENANTS],
            "jobs": [{"tenant": lb, "job_id": "all", "sources": [path],
                      "sink_dir": os.path.join(root, lb)}
                     for lb, _ in PHASE13_TENANTS]}
    os.makedirs(root)
    spec_path = os.path.join(root, "spec.json")
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    _zero(wrappers)
    old = signal.getsignal(signal.SIGTERM)
    t0 = time.perf_counter()
    try:
        rc, out = _tool("serve", "--device", device, spec_path)
    finally:
        signal.signal(signal.SIGTERM, old)
    serve_s = time.perf_counter() - t0
    launches = _launches_of(wrappers)
    if rc != 0:
        raise AssertionError(f"15e serve exited {rc}:\n{out}")
    _need("15e serve", launches, CONFIG2_KERNELS)
    _add(total, launches)
    for label, _ in PHASE13_TENANTS:
        files = sorted(os.listdir(os.path.join(root, label)))
        if files != sorted(f"unit{k}.npz" for k in range(len(results))):
            raise AssertionError(f"15e serve {label}: files {files}")
        for k, cols in enumerate(results):
            with np.load(os.path.join(root, label, f"unit{k}.npz")) as z:
                for name, col in cols.items():
                    for i, arr in enumerate(col.to_numpy()):
                        key = f"{name}.{i}"
                        if (arr is None) != (key not in z.files) or (
                                arr is not None and not _same_values(
                                    z[key], np.asarray(arr))):
                            raise AssertionError(
                                f"15e serve {label} unit {k}: {key}")
    print(f"15e parquet_tool serve ({serve_s:.2f} s): exit 0, "
          f"{len(results)} unit files a tenant equal 6a's arrays; "
          f"launches {launches}\n{out.rstrip()}", flush=True)
    rc, out = _tool("tenants", spec["status_export"])
    if rc != 0:
        raise AssertionError(f"15e tenants exited {rc}")
    print(f"15e parquet_tool tenants: exit 0\n{out.rstrip()}", flush=True)
    rc, out = _tool("meta", path)
    if rc != 0:
        raise AssertionError(f"15e meta exited {rc}")
    lines = out.rstrip().splitlines()
    print(f"15e parquet_tool meta: exit 0, {len(lines)} lines; "
          f"{' / '.join(lines[:7])}", flush=True)
    return total


def check_server(blob, results, reader, mesh, dev, wrappers,
                 pair13_s: float | None = None) -> dict:
    """Phase 15 (15a-15e), 15a's wall printed beside ``pair13_s`` (phase
    13's pair) when given; returns the launches of its paths."""
    t15 = time.perf_counter()
    total: dict = {}
    with tempfile.TemporaryDirectory(
            prefix=".smoke-", dir=os.path.dirname(
                os.path.abspath(__file__))) as tmp:
        path = os.path.join(tmp, "config2.parquet")
        with open(path, "wb") as f:
            f.write(blob)
        _add(total, check_server_pair(path, results, mesh, dev, wrappers,
                                      pair13_s))
        _add(total, check_drain_resume(path, results, mesh, dev, wrappers,
                                       tmp))
        _add(total, check_server_prefetch(path, results, reader, mesh, dev,
                                          wrappers, tmp))
        _add(total, check_server_plan_cache(path, results, reader, mesh,
                                            dev, wrappers))
        _add(total, check_tool(path, results, dev, wrappers, tmp))
    print(f"phase 15 (the scan server and the command-line tool): "
          f"{time.perf_counter() - t15:.2f} s", flush=True)
    return total


# ----------------------------------------------------------------------
# Phase 16: the dataset writer, a killed commit, compaction, floor
# ----------------------------------------------------------------------

# config 2 partitioned by rate_code (NYC TLC's RatecodeID, five values)
DATASET_KEY = "rate_code"
DATASET_COLUMNS = ("pickup_ts", "passenger_count", "trip_distance_mm",
                   "payment_type")
# 16c's data filter: trip_distance_mm below 2 km (about 3.8% of rows)
DATASET_NEAR_MM = 2000


def routed_kernels(st) -> list:
    """The kernels a read of config 2's columns launches by its routing:
    K1-K4 always, K5 when a page took byte planes and K7 when one took
    delta lanes.  The transports' competition decides per page, and a
    partition's or a small row group's pages can go either way."""
    return (["unpack_u32", "expand_hybrid", "page_dict_fixed",
             "levels_to_validity"]
            + (["planes_to_words"] if st.pages_device_planes else [])
            + (["delta_scan"] if st.pages_device_delta_lanes else []))


TRIP_SCHEMA = """message trip {
    required int64 pickup (TIMESTAMP(MILLIS, false));
    required int32 passenger_count;
    required int32 rate_code;
    required int64 trip_distance_mm;
    optional int32 payment_type;
}"""


@dataclasses.dataclass
class Trip:
    """16d's object: one config-2 row, ``pickup`` a datetime under
    TIMESTAMP(MILLIS)."""

    pickup: datetime.datetime
    passenger_count: int
    rate_code: int
    trip_distance_mm: int
    payment_type: Optional[int] = None


def _row_aligned(cols, mask) -> dict:
    """A config-2 row group's columns row-aligned: payment_type spread
    over its mask, 0 at the null rows."""
    pay = np.zeros(mask.size, dtype=np.int32)
    pay[mask] = cols["payment_type"]
    return {**cols, "payment_type": pay}


def _dataset_writer(root, **kw):
    """The port's DatasetWriter of config 2 (SNAPPY, as its file)."""
    from tpuparquet_torch import DatasetWriter
    from tpuparquet_torch.format.metadata import CompressionCodec

    return DatasetWriter(root, SCHEMA, [DATASET_KEY],
                         codec=CompressionCodec.SNAPPY, **kw)


def _write_groups(w, groups) -> None:
    """One ``write_columns`` a config-2 row group."""
    for cols, mask in groups:
        w.write_columns(_row_aligned(cols, mask),
                        masks={"payment_type": mask})


def _streams(groups, base=None) -> dict:
    """rate_code -> (row-aligned data columns, payment mask) of the rows
    of ``groups`` in the order they were written, after ``base``'s."""
    parts: dict = {}
    if base is not None:
        for code, s in base.items():
            parts[code] = [s]
    for cols, mask in groups:
        ra = _row_aligned(cols, mask)
        key = ra[DATASET_KEY]
        for code in np.unique(key).tolist():
            sel = key == code
            parts.setdefault(code, []).append(
                ({c: ra[c][sel] for c in DATASET_COLUMNS}, mask[sel]))
    return {code: ({c: np.concatenate([p[0][c] for p in lst])
                    for c in DATASET_COLUMNS},
                   np.concatenate([p[1] for p in lst]))
            for code, lst in parts.items()}


def _unit_rows(out) -> tuple:
    """A unit's DeviceColumns as row-aligned host columns and the
    payment mask."""
    cols = {}
    mask = out["payment_type"].mask.cpu().numpy()
    for name in DATASET_COLUMNS:
        vals = out[name].to_numpy()[0]
        if name == "payment_type":
            full = np.zeros(mask.size, dtype=vals.dtype)
            full[mask] = vals
            vals = full
        cols[name] = vals
    return cols, mask


def _dataset_scan(label, root, mesh, dev, wrappers, filter=None) -> dict:
    """A ``DatasetScan`` of ``root`` on ``mesh``, the counts set to 0 just
    before: its files (manifest path -> partition code, its units' rows
    in row-group order), the units (path, row group, rows), the
    launches, the collector and the wall (open and run)."""
    from tpuparquet_torch import DatasetScan
    from tpuparquet_torch.stats import collect_stats

    for fn in wrappers.values():
        fn.launches = 0
    with collect_stats() as st:
        t0 = time.perf_counter()
        ds = DatasetScan(root, mesh=mesh, filter=filter)
        results = ds.run()
        _sync(dev)
        wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in wrappers.items()}
    _no_ladder(label, st)
    path_of = [os.path.relpath(s, root).replace(os.sep, "/")
               for s in ds.sources]
    code_of = {p: part[DATASET_KEY]
               for p, (_, part, _, _) in zip(path_of, ds.files())}
    units = []
    for (fi, rgi), out in zip(ds.units, results):
        units.append((path_of[fi], rgi, _unit_rows(out)))
    files_pruned = ds.files_pruned
    ds.close()
    del results
    files: dict = {}
    for path, rgi, rows in sorted(units, key=lambda u: (u[0], u[1])):
        files.setdefault(path, []).append(rows)
    files = {p: ({c: np.concatenate([r[0][c] for r in lst])
                  for c in DATASET_COLUMNS},
                 np.concatenate([r[1] for r in lst]))
             for p, lst in files.items()}
    return {"files": files, "code_of": code_of, "units": units,
            "launches": launches, "stats": st, "wall": wall,
            "files_pruned": files_pruned}


def _locate(label, scan, streams) -> dict:
    """Each scanned file's rows as a run of its partition's stream: path
    -> (code, start, rows).  The runs tile every stream exactly, and a
    file lies under its own ``rate_code=<v>/`` directory."""
    spans = {}
    for path, (cols, mask) in scan["files"].items():
        code = scan["code_of"][path]
        if not path.startswith(f"{DATASET_KEY}={code}/"):
            raise AssertionError(f"{label}: {path} is not under its "
                                 f"partition {code}")
        s_cols, s_mask = streams[code]
        n = mask.size
        found = None
        for pos in np.flatnonzero(
                s_cols["pickup_ts"] == cols["pickup_ts"][0]).tolist():
            if pos + n <= s_mask.size and np.array_equal(
                    s_mask[pos:pos + n], mask) and all(
                    np.array_equal(s_cols[c][pos:pos + n], cols[c])
                    for c in DATASET_COLUMNS):
                found = pos
                break
        if found is None:
            raise AssertionError(f"{label}: {path}'s rows are no run of "
                                 f"partition {code}'s rows")
        spans[path] = (code, found, n)
    for code, (_, s_mask) in streams.items():
        runs = sorted((s, n) for c, s, n in spans.values() if c == code)
        at = 0
        for s, n in runs:
            if s != at:
                raise AssertionError(f"{label}: partition {code}'s files "
                                     f"leave a gap or overlap at row {at}")
            at += n
        if at != s_mask.size:
            raise AssertionError(f"{label}: partition {code}'s files hold "
                                 f"{at} rows, written {s_mask.size}")
    return spans


def _manifest(root) -> tuple:
    from tpuparquet_torch.dataset.manifest import resolve_manifest

    body, version, findings = resolve_manifest(root)
    if body is None or findings:
        raise AssertionError(f"{root}: no valid snapshot ({findings})")
    return body, version


def _check_addresses(label, root) -> dict:
    """Every manifest entry's name is the SHA-1 (first 16 hex digits) of
    its file's bytes, with its size; returns the snapshot's body."""
    import hashlib

    body, _ = _manifest(root)
    for e in body["files"]:
        with open(os.path.join(root, e["path"]), "rb") as f:
            data = f.read()
        digest = hashlib.sha1(data).hexdigest()[:16]
        if e["path"].rsplit("/", 1)[-1] != f"part-{digest}.parquet" \
                or e["sha1"] != digest or e["bytes"] != len(data):
            raise AssertionError(f"{label}: {e['path']} is not the "
                                 "address of its bytes")
    return body


def _want_pruning(root, spans, streams, page_rows: int) -> dict:
    """16c's filter on the snapshot's files: the survivors of each
    (path, row group) and the counters the scan must give, from each
    file's page index (a page of trip_distance_mm is a candidate when
    its minimum is below DATASET_NEAR_MM; a row group with none is
    pruned) and its rows in the generator's streams."""
    from tpuparquet_torch.io.reader import FileReader

    want = dict.fromkeys(PRUNE_COUNTERS, 0)
    keep_of = {}
    for path, (code, start, _) in sorted(spans.items()):
        s_cols, _ = streams[code]
        with FileReader(os.path.join(root, path)) as r:
            keeps, cands, pruned = [], [], []
            at = start
            for rg in range(r.row_group_count()):
                n = r.meta.row_groups[rg].num_rows
                keep = s_cols["trip_distance_mm"][at:at + n] \
                    < DATASET_NEAR_MM
                pages = r.page_index(rg, ["trip_distance_mm"])[
                    "trip_distance_mm"]
                cand = np.array([p[2] < DATASET_NEAR_MM for p in pages])
                if not cand.any():
                    pruned.append(rg)
                keeps.append(keep)
                cands.append(cand)
                keep_of[(path, rg)] = (at, keep)
                at += n
        got = _want_counts(keeps, cands, pruned, page_rows,
                           len(DATASET_COLUMNS), 1)
        for k in PRUNE_COUNTERS:
            want[k] += got[k]
    return {"counters": want, "keep_of": keep_of}


def _check_filtered_scan(label, scan, want, streams, spans) -> None:
    """A filtered scan's units against the generator's survivors, and
    its pruning counters against ``want``."""
    for path, rg, (cols, mask) in scan["units"]:
        code = spans[path][0]
        at, keep = want["keep_of"][(path, rg)]
        s_cols, s_mask = streams[code]
        n = keep.size
        if not np.array_equal(mask, s_mask[at:at + n][keep]) or not all(
                np.array_equal(cols[c], s_cols[c][at:at + n][keep])
                for c in DATASET_COLUMNS):
            raise AssertionError(f"{label}: {path} row group {rg}'s "
                                 "survivors differ from the generator's")
    got = {k: getattr(scan["stats"], k) for k in PRUNE_COUNTERS}
    if got != want["counters"]:
        raise AssertionError(f"{label}: counters {got}, expected "
                             f"{want['counters']}")


def dataset_child(argv) -> int:
    """16b's child: ``ROOT VALUES SEED``.  A spare writer's partial (up
    to 1,000 rows of one partition) is left open, an orphan once this
    process dies; then one config-2 row
    group of ``VALUES`` values (seed ``SEED``) is committed on top of
    ROOT's snapshot; the process SIGKILLs itself at the commit's first
    promote step."""
    import signal

    root, n_values, seed = argv[0], int(argv[1]), int(argv[2])
    ((cols, mask),) = config2_groups(n_values, 1, seed)
    spare = _dataset_writer(root)
    ra = _row_aligned(cols, mask)
    head = np.flatnonzero(ra[DATASET_KEY] == ra[DATASET_KEY][0])[:1000]
    spare.write_columns({c: v[head] for c, v in ra.items()},
                        masks={"payment_type": mask[head]})

    def hook(label):
        if label[0] == "promote":
            os.kill(os.getpid(), signal.SIGKILL)

    w = _dataset_writer(root, step_hook=hook)
    _write_groups(w, [(cols, mask)])
    w.commit()
    return 3  # the hook kills the process before this


def _run_dataset_child(root, n_values: int, seed: int, knobs: dict):
    """16b's child through ``python -c`` in this script's directory, with
    a timeout of its own; returns its pid once it died by SIGKILL."""
    import signal

    here = os.path.dirname(os.path.abspath(__file__))
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "import chip_smoke; "
            "sys.exit(chip_smoke.dataset_child(sys.argv[2:]))")
    env = dict(os.environ)
    env.update(knobs)
    proc = subprocess.Popen(
        [sys.executable, "-c", code, here, root, str(n_values), str(seed)],
        cwd=here, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    try:
        out, err = proc.communicate(timeout=300)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise
    if proc.returncode != -signal.SIGKILL:
        raise AssertionError(f"16b: the child exited {proc.returncode}, "
                             f"not by SIGKILL: {err.decode()[-2000:]}")
    return proc.pid


def check_dataset(groups, mesh, dev, wrappers, target_mb: float = 8,
                  compact_mb: float = 64, page_rows: int = 65_536) -> dict:
    """Phase 16 (16a-16c), config 2's rows partitioned by rate_code
    through the port's DatasetWriter; returns the launches of its scans.
    ``target_mb``, ``compact_mb`` and ``page_rows`` are the write's and
    the compaction's ``TPQ_DATASET_TARGET_MB`` and ``TPQ_PAGE_ROWS``."""
    from tpuparquet_torch import col
    from tpuparquet_torch.dataset import sweep_orphans
    from tpuparquet_torch.faults import QuarantineReport

    t16 = time.perf_counter()
    total: dict = {}
    knobs = {"TPQ_DATASET_TARGET_MB": str(target_mb),
             "TPQ_PAGE_ROWS": str(page_rows)}
    with tempfile.TemporaryDirectory(
            prefix=".smoke-", dir=os.path.dirname(
                os.path.abspath(__file__))) as tmp:
        root = os.path.join(tmp, "trips")
        # 16a: the partitioned write, one write_columns a row group
        with _env(**knobs):
            t0 = time.perf_counter()
            with _dataset_writer(root) as w:
                _write_groups(w, groups)
            write_s = time.perf_counter() - t0
        body = _check_addresses("16a", root)
        streams = _streams(groups)
        scan = _dataset_scan("16a", root, mesh, dev, wrappers)
        spans = _locate("16a", scan, streams)
        _need("16a", scan["launches"], routed_kernels(scan["stats"]))
        _add(total, scan["launches"])
        n_rows = sum(m.size for _, m in streams.values())
        per_part = {c: int(m.size) for c, (_, m) in sorted(streams.items())}
        print(f"16a DatasetWriter: {n_rows} rows into {len(body['files'])} "
              f"files over {len(streams)} partitions {per_part}, written and "
              f"committed in {write_s:.2f} s "
              f"({n_rows / write_s:.0f} rows/s); every name the SHA-1 of "
              f"its bytes; DatasetScan on {dev}: {scan['wall']:.4f} s, "
              f"{len(scan['units'])} units, each partition's rows the "
              f"generator's in write order; pages through planes "
              f"{scan['stats'].pages_device_planes}, delta lanes "
              f"{scan['stats'].pages_device_delta_lanes} of "
              f"{scan['stats'].pages}; launches {scan['launches']}",
              flush=True)

        # 16b: a commit killed at its first promote, then resumed
        per = groups[0][1].size
        ((cols_b, mask_b),) = config2_groups(5 * per, 1, 7)
        t0 = time.perf_counter()
        pid = _run_dataset_child(root, 5 * per, 7, knobs)
        child_s = time.perf_counter() - t0
        scan = _dataset_scan("16b killed", root, mesh, dev, wrappers)
        if _locate("16b killed", scan, streams) != spans:
            raise AssertionError("16b: the killed commit changed the "
                                 "visible files")
        _add(total, scan["launches"])
        t0 = time.perf_counter()
        with _env(**knobs), _dataset_writer(root, resume_from=root) as w:
            version = w.commit()
        resume_s = time.perf_counter() - t0
        if version != 2:
            raise AssertionError(f"16b: the resume published version "
                                 f"{version}, not 2")
        streams = _streams([(cols_b, mask_b)], base=streams)
        _check_addresses("16b", root)
        scan = _dataset_scan("16b resumed", root, mesh, dev, wrappers)
        spans = _locate("16b resumed", scan, streams)
        _add(total, scan["launches"])
        q = QuarantineReport()
        swept = sweep_orphans(root, quarantine=q)
        orphan = f".partial.{pid}.1"
        if swept != [f"_tmp/{orphan}"] or not os.path.exists(
                os.path.join(root, "_quarantine", orphan)) \
                or os.listdir(os.path.join(root, "_tmp")):
            raise AssertionError(f"16b: swept {swept}, expected the dead "
                                 f"child's partial {orphan}")
        print(f"16b a commit of {mask_b.size} rows killed at its first "
              f"promote (child {child_s:.2f} s with its start): the scan "
              f"saw 16a's rows; resume_from= published v{version} in "
              f"{resume_s:.3f} s, the scan {scan['wall']:.4f} s saw 16a's "
              f"rows and the new group's, each once; sweep_orphans moved "
              f"{swept} to _quarantine/", flush=True)

        # 16c: the filtered scan, compaction through the CLI, the same
        # scan again, and a partition filter
        near = col("trip_distance_mm") < DATASET_NEAR_MM
        want = _want_pruning(root, spans, streams, page_rows)
        before = _dataset_scan("16c before", root, mesh, dev, wrappers,
                               filter=near)
        _check_filtered_scan("16c before", before, want, streams, spans)
        _add(total, before["launches"])
        v2, _ = _manifest(root)
        old = sorted(e["path"] for e in v2["files"])
        env = dict(os.environ)
        env.update(knobs, TPQ_DATASET_TARGET_MB=str(compact_mb))
        t0 = time.perf_counter()
        res = subprocess.run(
            [sys.executable, "-m", "tpuparquet_torch.cli.parquet_tool",
             "compact", "--sort-by", "trip_distance_mm", "--keep", "1",
             root], cwd=os.path.dirname(os.path.abspath(__file__)),
            env=env, capture_output=True, text=True, timeout=900)
        compact_s = time.perf_counter() - t0
        v3, version = _manifest(root)
        lines = res.stdout.splitlines()
        head = (f"compacted {root}: {len(old)} -> {len(v3['files'])} "
                f"files, {n_rows + mask_b.size} rows, manifest v{version}")
        if res.returncode != 0 or not lines or lines[0] != head \
                or sorted(ln for ln in lines[1:]) != sorted(
                    f"  gc {p}" for p in old):
            raise AssertionError(f"16c: compact exited {res.returncode}: "
                                 f"{res.stdout[-2000:]} "
                                 f"{res.stderr[-2000:]}")
        _check_addresses("16c", root)
        # the compaction reads each partition's files in manifest order
        # and sorts the rows stably by trip_distance_mm
        ordered = {}
        for code in streams:
            s_cols, s_mask = streams[code]
            runs = [spans[p][1:] for p in old if spans[p][0] == code]
            idx = np.concatenate([np.arange(s, s + n) for s, n in runs])
            idx = idx[np.argsort(s_cols["trip_distance_mm"][idx],
                                 kind="stable")]
            ordered[code] = ({c: s_cols[c][idx] for c in DATASET_COLUMNS},
                             s_mask[idx])
        scan = _dataset_scan("16c compacted", root, mesh, dev, wrappers)
        c_spans = _locate("16c compacted", scan, ordered)
        _add(total, scan["launches"])
        want_after = _want_pruning(root, c_spans, ordered, page_rows)
        after = _dataset_scan("16c after", root, mesh, dev, wrappers,
                              filter=near)
        _check_filtered_scan("16c after", after, want_after, ordered,
                             c_spans)
        _add(total, after["launches"])
        three = _dataset_scan("16c rate_code == 3", root, mesh, dev,
                              wrappers, filter=col(DATASET_KEY) == 3)
        others = sum(1 for e in v3["files"]
                     if e["partition"][DATASET_KEY] != 3)
        if three["stats"].dataset_files_pruned != others \
                or three["files_pruned"] != others or set(
                    three["code_of"].values()) != {3}:
            raise AssertionError(
                f"16c: rate_code == 3 pruned "
                f"{three['stats'].dataset_files_pruned} files, expected "
                f"{others}")
        _locate("16c rate_code == 3", three, {3: ordered[3]})
        _add(total, three["launches"])
        print(f"16c parquet_tool compact --sort-by trip_distance_mm "
              f"--keep 1: {compact_s:.2f} s with its start, "
              f"'{lines[0]}', {len(lines) - 1} gc lines; the rows stably "
              f"sorted by trip_distance_mm within each partition; "
              f"trip_distance_mm < {DATASET_NEAR_MM}: before "
              f"{before['wall']:.4f} s, pages_pruned "
              f"{before['stats'].pages_pruned}, after "
              f"{after['wall']:.4f} s, pages_pruned "
              f"{after['stats'].pages_pruned} (both from the page "
              f"statistics), {after['stats'].filter_rows_out} rows the "
              f"generator's; rate_code == 3 pruned {others} files",
              flush=True)
    print(f"phase 16a-c (the dataset writer, a killed commit, "
          f"compaction): {time.perf_counter() - t16:.2f} s", flush=True)
    return total


def check_floor(groups, dev, wrappers, n_objects: int = 1_000_000,
                n_row_path: int = 10_000) -> dict:
    """Phase 16d: ``n_objects`` of config 2's rows as :class:`Trip`
    objects written by ``floor.Writer.write_columns`` in four row groups,
    read on ``dev`` against the generator; ``floor.Reader``'s first
    ``n_row_path`` objects; the row path's file of those objects against
    the columnar path's.  Returns the read's launches."""
    from tpuparquet_torch import floor
    from tpuparquet_torch.format.metadata import CompressionCodec
    from tpuparquet_torch.io.reader import FileReader
    from tpuparquet_torch.io.writer import FileWriter

    t16 = time.perf_counter()
    cols, mask = groups[0]
    n = min(n_objects, mask.size)
    ra = {k: v[:n] for k, v in _row_aligned(cols, mask).items()}
    mask = mask[:n]
    epoch = datetime.datetime(1970, 1, 1)
    objs = [Trip(epoch + datetime.timedelta(milliseconds=t), p, r, d,
                 y if m else None)
            for t, p, r, d, y, m in zip(
                ra["pickup_ts"].tolist(), ra["passenger_count"].tolist(),
                ra["rate_code"].tolist(), ra["trip_distance_mm"].tolist(),
                ra["payment_type"].tolist(), mask.tolist())]

    def columnar(batch, n_groups):
        buf = io.BytesIO()
        w = floor.Writer(FileWriter(buf, TRIP_SCHEMA,
                                    codec=CompressionCodec.SNAPPY))
        step = -(-len(batch) // n_groups)
        for lo in range(0, len(batch), step):
            w.write_columns(batch[lo:lo + step])
        w.close()
        return buf.getvalue()

    t0 = time.perf_counter()
    blob = columnar(objs, 4)
    col_s = time.perf_counter() - t0
    from tpuparquet_torch.kernels.device import read_row_groups_device
    from tpuparquet_torch.stats import collect_stats

    reader = FileReader(blob)
    for fn in wrappers.values():
        fn.launches = 0
    with collect_stats() as st:
        t0 = time.perf_counter()
        got = list(read_row_groups_device(reader, device=dev))
        _sync(dev)
        read_s = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in wrappers.items()}
    _no_ladder("16d", st)
    if len(got) != 4:
        raise AssertionError(f"16d: {len(got)} row groups, not 4")
    at = 0
    for rg, out in got:
        rows = out["payment_type"].num_values
        want = {"pickup": ra["pickup_ts"][at:at + rows],
                "passenger_count": ra["passenger_count"][at:at + rows],
                "rate_code": ra["rate_code"][at:at + rows],
                "trip_distance_mm": ra["trip_distance_mm"][at:at + rows]}
        m = mask[at:at + rows]
        for name, vals in want.items():
            if not _same_values(out[name].to_numpy()[0], vals):
                raise AssertionError(f"16d row group {rg} {name} differs")
        pay = out["payment_type"]
        if not np.array_equal(pay.mask.cpu().numpy(), m) or not \
                _same_values(pay.to_numpy()[0],
                             ra["payment_type"][at:at + rows][m]):
            raise AssertionError(f"16d row group {rg} payment_type "
                                 "differs")
        at += rows
    if at != n:
        raise AssertionError(f"16d: {at} rows read, wrote {n}")
    _need("16d", launches, routed_kernels(st))
    del got
    k = min(n_row_path, n)
    r = floor.Reader(FileReader(blob), cls=Trip)
    back = []
    while len(back) < k and r.next():
        back.append(r.scan())
    if back != objs[:k]:
        raise AssertionError("16d: floor.Reader's objects differ")
    t0 = time.perf_counter()
    buf = io.BytesIO()
    w = floor.Writer(FileWriter(buf, TRIP_SCHEMA,
                                codec=CompressionCodec.SNAPPY))
    w.write_many(objs[:k])
    w.close()
    row_s = time.perf_counter() - t0
    rows_blob, cols_blob = buf.getvalue(), columnar(objs[:k], 1)
    a = FileReader(rows_blob).read_row_group_arrays(0)
    b = FileReader(cols_blob).read_row_group_arrays(0)
    for name in b:
        if not (np.array_equal(a[name].def_levels, b[name].def_levels)
                and _same_values(np.asarray(a[name].values),
                                 np.asarray(b[name].values))):
            raise AssertionError(f"16d: the row path's {name} differs "
                                 "from the columnar path's")
    print(f"16d floor: {n} Trip objects by write_columns in 4 row groups "
          f"{col_s:.2f} s ({n / col_s:.0f} objects/s); the row path "
          f"(write_many) {k} objects {row_s:.2f} s ({k / row_s:.0f} "
          f"objects/s), its columns the columnar path's; "
          f"read_row_groups_device on {dev} {read_s:.4f} s, the "
          f"generator's columns; floor.Reader's first {k} objects equal; "
          f"launches {launches}; phase 16d {time.perf_counter() - t16:.2f} "
          "s", flush=True)
    return launches


# ----------------------------------------------------------------------
# Phase 17: the lock-order recorder and the port's analyzer
# ----------------------------------------------------------------------

PHASE17_PLAN_THREADS = 8
PHASE17_CHILD_S = 600.0


def _lock_waits(state: dict) -> dict:
    """``[lock-wait <site>]`` samples of a profiler state, by site."""
    out: dict = {}
    for stages in (state.get("buckets") or {}).values():
        for b in stages.values():
            for stack, n in b["stacks"].items():
                leaf = stack.rsplit(";", 1)[-1]
                if leaf.startswith("[lock-wait ") and leaf.endswith("]"):
                    site = leaf[len("[lock-wait "):-1]
                    out[site] = out.get(site, 0) + int(n)
    return out


def _armed_walls(reader, dev, wrappers, g2, label, reps: int = 3):
    """``reps`` passes of config 2 at phase 17's plan workers, the first
    checked against the generator (and, on a card, for K1-K5 and K7);
    (best wall, the first's launches)."""
    walls, first = [], None
    with _plan_threads_env(PHASE17_PLAN_THREADS):
        for i in range(reps):
            t0 = time.perf_counter()
            got, launches, _st = _drive(reader, dev, wrappers)
            walls.append(time.perf_counter() - t0)
            if i == 0:
                _check_values(label, got, g2)
                _need_on(dev, label, launches)
                first = launches
            del got
    return min(walls), first


def _need_on(dev, label, launches) -> None:
    """Config 2's kernels launched, on a card (a CPU rehearsal runs the
    plain versions, which count nothing)."""
    if dev.type == "cuda":
        _need(label, launches, CONFIG2_KERNELS)


def lockcheck_child(argv) -> int:
    """Phase 17a's child (``chip_smoke.py --lockcheck-child OUT PATH
    VALUES GROUPS CACHE DEVICE``), under ``TPQ_LOCKCHECK=strict``,
    ``TPQ_LOCKCHECK_OUT`` and ``TPQ_PROFILE=1``: config 2 from PATH at 8
    plan workers, a ``ShardedScan`` over ``emu://`` with the disk tier in
    CACHE and one ``ScanServer`` job at prefetch depth 2, each on DEVICE
    (``cuda``: this process's card) against the generator
    (``config2_groups(VALUES, GROUPS)``); writes to OUT the pass's best
    wall, the launches and the lock-wait samples by site."""
    out, path, n_values, n_groups, cache, device = argv
    if device == "cuda" and not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from tpuparquet_torch import ShardedScan, lockcheck, make_mesh
    from tpuparquet_torch.io.reader import FileReader
    from tpuparquet_torch.obs import profiler

    if not (lockcheck.installed() and lockcheck._strict):
        raise AssertionError("17a: the recorder is not installed strict")
    if profiler.profiler() is None:
        raise AssertionError("17a: the profiler is not armed")
    dev = torch.device(device, 0) if device == "cuda" \
        else torch.device(device)
    g2 = [(c, {"payment_type": m})
          for c, m in config2_groups(int(n_values), int(n_groups))]
    wrappers = kernel_wrappers()
    total: dict = {}
    with FileReader(path) as reader:
        wall, launches = _armed_walls(reader, dev, wrappers, g2,
                                      "17a armed read")
    _add(total, launches)
    mesh = make_mesh() if dev.type == "cuda" else make_mesh(
        1, devices=[dev.type])
    with _env(TPQ_CACHE_DISK_DIR=cache, TPQ_CACHE_DISK_MB=None,
              TPQ_CACHE_DISK_SHARED=None, **PHASE14_EMU_KNOBS):
        _fresh_tier(cache)
        _zero(wrappers)
        with ShardedScan(["emu://" + path], mesh=mesh) as scan:
            units = scan.run()
        _sync(dev)
        launches = _launches_of(wrappers)
        _need_on(dev, "17a emu:// scan", launches)
        _add(total, launches)
        _check_values("17a emu:// scan", list(enumerate(units)), g2)
        del units
        _fresh_tier(cache)
        with _env(TPQ_PREFETCH_DEPTH=2):
            _zero(wrappers)
            srv = _server(mesh)
            try:
                job = srv.submit("light", ["emu://" + path])
                _done("17a server job", [job])
                _sync(dev)
            finally:
                srv.shutdown()
        launches = _launches_of(wrappers)
        _need_on(dev, "17a server job", launches)
        _add(total, launches)
        _check_values("17a server job", sorted(job.outputs.items()), g2)
        del job
    state = profiler.profiler().to_state()
    with open(out, "w") as f:
        json.dump({"wall": wall, "launches": total,
                   "lock_waits": _lock_waits(state),
                   "samples": state["counters"]}, f)
    return 0


def check_lockcheck(blob, groups, n_values: int, n_groups: int, dev,
                    wrappers, smi: str) -> dict:
    """Phase 17 (17a, 17b; see the module docstring); returns the
    child's launches."""
    here = os.path.dirname(os.path.abspath(__file__))
    t17 = time.perf_counter()
    g2 = [(c, {"payment_type": m}) for c, m in groups]
    with tempfile.TemporaryDirectory(prefix=".smoke-", dir=here) as tmp:
        path = os.path.join(tmp, "config2.parquet")
        with open(path, "wb") as f:
            f.write(blob)
        from tpuparquet_torch.io.reader import FileReader

        with FileReader(path) as reader:
            plain_wall, _l = _armed_walls(reader, dev, wrappers, g2,
                                          "17a unarmed read")
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        out = os.path.join(tmp, "child.json")
        dump = os.path.join(tmp, "locks.json")
        env = dict(os.environ, TPQ_LOCKCHECK="strict",
                   TPQ_LOCKCHECK_OUT=dump, TPQ_PROFILE="1")
        for k in ("TPQ_PROFILE_EXPORT", "TPQ_PLAN_THREADS"):
            env.pop(k, None)
        t0 = time.perf_counter()
        try:
            child = subprocess.run(
                [sys.executable, os.path.abspath(__file__),
                 "--lockcheck-child", out, path, str(n_values),
                 str(n_groups), os.path.join(tmp, "cache"), dev.type],
                env=env, cwd=here, capture_output=True, text=True,
                timeout=PHASE17_CHILD_S)
        except subprocess.TimeoutExpired as e:
            raise AssertionError(f"17a: the child ran past "
                                 f"{PHASE17_CHILD_S} s") from e
        child_s = time.perf_counter() - t0
        if child.returncode != 0:
            raise AssertionError(f"17a: the child exited "
                                 f"{child.returncode}: "
                                 f"{child.stderr[-3000:]}")
        with open(out) as f:
            got = json.load(f)
        with open(dump) as f:
            doc = json.load(f)
        sites = doc["locks"]
        edges = doc["edges"]
        ours = [x for x in sites if x.startswith("tpuparquet_torch/")]
        if doc["violations"]:
            raise AssertionError(f"17a: violations {doc['violations']}")
        if not ours:
            raise AssertionError("17a: no tpuparquet_torch/ lock recorded")
        verify = subprocess.run(
            [sys.executable, "-m", "tpuparquet_torch.analyze",
             "--verify-lockcheck", dump, "--json"], cwd=here,
            capture_output=True, text=True, timeout=300)
        res = json.loads(verify.stdout)
        if verify.returncode != 0 or res["problems"]:
            raise AssertionError(f"17a: --verify-lockcheck: "
                                 f"{res['problems']}")
    repo_edges = [e for e in edges if e[0].startswith("tpuparquet_torch/")
                  and e[1].startswith("tpuparquet_torch/")]
    print(f"17a lockcheck (strict): {len(sites)} sites ({len(ours)} in "
          f"tpuparquet_torch/), {len(edges)} edges ({len(repo_edges)} "
          f"between package locks), no violation; --verify-lockcheck "
          f"against the static graph: 0 problems; the child "
          f"{child_s:.2f} s with its start", flush=True)
    waits = got["lock_waits"]
    print(f"17a [lock-wait <site>] samples by site: "
          f"{waits if waits else 'none (0 samples: no repo lock waited long enough to be sampled)'}; "
          f"profiler counters {got['samples']}", flush=True)
    print(f"17a config 2 at {PHASE17_PLAN_THREADS} plan workers, best of "
          f"3: armed (recorder strict, profiler on) {got['wall']:.4f} s, "
          f"unarmed {plain_wall:.4f} s, ratio "
          f"{got['wall'] / plain_wall:.3f} ({smi})", flush=True)

    # 17b: the analyzer's gate through the command-line tool
    t0 = time.perf_counter()
    tool = subprocess.run(
        [sys.executable, "-m", "tpuparquet_torch.cli.parquet_tool",
         "analyze", "--json"], cwd=here, capture_output=True, text=True,
        timeout=300)
    gate = json.loads(tool.stdout) if tool.stdout.strip() else {}
    if tool.returncode != 0 or gate.get("findings") or not gate.get("ok"):
        raise AssertionError(f"17b: parquet_tool analyze exited "
                             f"{tool.returncode}: "
                             f"{gate.get('findings')} "
                             f"{tool.stderr[-2000:]}")
    print(f"17b parquet_tool analyze: 0 findings, "
          f"{len(gate['suppressed'])} allowlisted, 0 stale, "
          f"{time.perf_counter() - t0:.2f} s with its start; passes "
          f"{gate['timings_s']}", flush=True)
    print(f"phase 17 (lockcheck, the analyzer): "
          f"{time.perf_counter() - t17:.2f} s", flush=True)
    return got["launches"]


def kernel_wrappers() -> dict:
    """Every kernel's wrapper by name; each counts its launches in its
    ``launches`` attribute."""
    from tpuparquet_torch.kernels import bitunpack, decode, encode, gather, \
        hybrid, snappy

    return {"unpack_u32": bitunpack.unpack_u32,
            "expand_hybrid": hybrid.expand_hybrid,
            "page_dict_fixed": decode.page_dict_fixed,
            "levels_to_validity": decode.levels_to_validity,
            "planes_to_words": decode.planes_to_words,
            "unpack_u64": bitunpack.unpack_u64,
            "delta_scan": decode.delta_scan,
            "expand_tokens": snappy.expand_tokens,
            "page_dict_bytes": decode.page_dict_bytes,
            "plain_bytes_from_blob": decode.plain_bytes_from_blob,
            "scatter_deltas": decode.scatter_deltas,
            "bss_to_lanes": decode.bss_to_lanes,
            "flba_bytes_to_lanes": decode.flba_bytes_to_lanes,
            "pack_bits": encode.pack_bits,
            "bss_encode_device": encode.bss_encode_device,
            "delta_phase1": encode.delta_phase1,
            "dict_build": encode.dict_build,
            "lanes_min_max": encode.lanes_min_max,
            "scatter_to_dense": decode.scatter_to_dense,
            "spmd_step_slot": gather.spmd_step_slot,
            "byte_densify": gather.byte_densify,
            "place_rows": gather.place_rows}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--multihost-child"]:
        return multihost_child(argv[1:])
    if argv[:1] == ["--remote-child"]:
        return remote_child(argv[1:])
    if argv[:1] == ["--lockcheck-child"]:
        return lockcheck_child(argv[1:])
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--values", type=int, default=50_000_000)
    ap.add_argument("--groups", type=int, default=8)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2

    from tpuparquet_torch.compress import _snappy
    from tpuparquet_torch.io.reader import FileReader
    from tpuparquet_torch.kernels._lib import build_kernels
    from tpuparquet_torch.native import bytes_native, delta_native, \
        hybrid_native, intern_native, pack_native, page_native, \
        plane_native

    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    print(f"device: {kind}", flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    smi_line = (smi.stdout.strip().splitlines()[0] if smi.stdout.strip()
                else "nvidia-smi: no output")
    print(smi_line, flush=True)
    print(f"host: {len(os.sched_getaffinity(0))} usable CPUs "
          "(os.sched_getaffinity)", flush=True)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}", flush=True)

    codec_backends()

    # phase 1: build
    t0 = time.perf_counter()
    build_s = build_kernels()
    _snappy()
    for native in (hybrid_native, pack_native, delta_native, plane_native,
                   bytes_native, intern_native, page_native):
        native()
    print(f"build: kernels {build_s:.2f} s, with the C host helpers "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    # phase 2: each kernel against its plain version
    t0 = time.perf_counter()
    check_kernels(dev)
    print(f"kernels: bit-exact against their plain versions "
          f"({time.perf_counter() - t0:.2f} s)", flush=True)

    wrappers = kernel_wrappers()
    total_launches = dict.fromkeys(wrappers, 0)
    g = args.groups

    # phase 3: config 2, default transports, then none
    t0 = time.perf_counter()
    blob, groups = build_config2(args.values, g)
    print(f"config 2: {g} row groups, {len(blob)} bytes, written in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    reader = FileReader(blob)
    print(f"plan workers: {_plan_workers(None)} by default "
          "(TPQ_PLAN_THREADS, else the usable CPUs)", flush=True)
    for on, label in ((True, "config 2 transports"),
                      (False, "config 2 no transports")):
        _set_transports(on)
        got, launches, st = _drive(reader, dev, wrappers)
        print(f"{label} launches: {launches}", flush=True)
        n_values = _check_read(label, reader, got,
                               [(c, {"payment_type": m}) for c, m in groups])
        _same_at_one_worker(label, reader, dev, wrappers, got, launches, st)
        if on:
            with tempfile.TemporaryDirectory(
                    prefix=".smoke-", dir=os.path.dirname(
                        os.path.abspath(__file__))) as tmp:
                path = os.path.join(tmp, "config2.parquet")
                with open(path, "wb") as f:
                    f.write(blob)
                check_range_reads(label, path, got, dev, wrappers)
        del got
        _routing(label, st, {"pages_device_delta_lanes": g if on else 0,
                             "pages_device_planes": g if on else 0,
                             "pages_device_snappy": 0})
        _need(label, launches, ["unpack_u32", "expand_hybrid",
                                "page_dict_fixed", "levels_to_validity"]
              + (["planes_to_words", "delta_scan"] if on else []))
        for k, c in launches.items():
            total_launches[k] += c
        if on:
            snappy_read = (launches, st)
            c2_pass_s = _best_of(label, reader, dev, n_values)[0]
        else:
            _best_of(label, reader, dev, n_values)
    _set_transports(True)
    sweep_workers("config 2 transports", reader, dev, n_values)
    check_plan_cache("config 2", reader, dev, wrappers)

    # phase 3b: the transport mix, default transports
    t0 = time.perf_counter()
    mix_blob, mix_groups = build_mix(args.values, g)
    print(f"transport mix: {g} row groups, {len(mix_blob)} bytes, written "
          f"in {time.perf_counter() - t0:.2f} s", flush=True)
    mix_reader = FileReader(mix_blob)
    got, launches, st = _drive(mix_reader, dev, wrappers)
    print(f"transport mix launches: {launches}", flush=True)
    n_mix = _check_read("transport mix", mix_reader, got,
                        [(c, {"tok_opt": m}) for c, m in mix_groups])
    _same_at_one_worker("transport mix", mix_reader, dev, wrappers, got,
                        launches, st)
    del got
    _routing("transport mix", st, {"pages_device_snappy": 2 * g,
                                   "pages_device_delta_lanes": 2 * g,
                                   "pages_device_planes": g})
    _need("transport mix", launches,
          ["unpack_u32", "levels_to_validity", "planes_to_words",
           "unpack_u64", "delta_scan", "expand_tokens"])
    for k, c in launches.items():
        total_launches[k] += c
    _best_of("transport mix", mix_reader, dev, n_mix)
    del mix_reader, mix_blob

    # phase 3c: config 4 (strings beside doubles, data page v2), default
    # transports
    t0 = time.perf_counter()
    blob4, groups4 = build_config4(args.values, g)
    print(f"config 4: {g} row groups, {len(blob4)} bytes, written in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    reader4 = FileReader(blob4)
    got, launches, st = _drive(reader4, dev, wrappers)
    print(f"config 4 launches: {launches}", flush=True)
    n4 = _check_read("config 4", reader4, got, groups4)
    _same_at_one_worker("config 4", reader4, dev, wrappers, got,
                        launches, st)
    del got
    _routing("config 4", st, {"pages_device_snappy": 0,
                              "pages_device_delta_lanes": 0,
                              "pages_device_planes": 0})
    _need("config 4", launches, ["page_dict_bytes", "levels_to_validity"])
    _need_any("config 4", launches, ["unpack_u32", "expand_hybrid"])
    for k, c in launches.items():
        total_launches[k] += c
    _best_of("config 4", reader4, dev, n4,
             note=" (the JAX package: 225,490,944 on bench.py's own file)")
    del reader4

    # phase 3d: the string mix, default transports
    t0 = time.perf_counter()
    blob_s, groups_s = build_strings(args.values, g)
    print(f"string mix: {g} row groups, {len(blob_s)} bytes, written in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    reader_s = FileReader(blob_s)
    got, launches, st = _drive(reader_s, dev, wrappers)
    print(f"string mix launches: {launches}", flush=True)
    n_s = _check_read("string mix", reader_s, got, groups_s)
    _same_at_one_worker("string mix", reader_s, dev, wrappers, got,
                        launches, st)
    del got
    _routing("string mix", st, {"pages_device_snappy": 2 * g,
                                "pages_device_delta_lanes": 0,
                                "pages_device_planes": 0})
    _need("string mix", launches, ["expand_tokens", "plain_bytes_from_blob",
                                   "levels_to_validity"])
    for k, c in launches.items():
        total_launches[k] += c
    _best_of("string mix", reader_s, dev, n_s)
    del reader_s  # phase 9d scans blob_s again

    # phase 3e: config 3 (DELTA_BINARY_PACKED timestamps in a nullable
    # LIST), default transports
    t0 = time.perf_counter()
    blob3, groups3 = build_config3(args.values, g)
    print(f"config 3: {g} row groups, {len(blob3)} bytes, written in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    reader3 = FileReader(blob3)
    got, launches, st = _drive(reader3, dev, wrappers)
    print(f"config 3 launches: {launches}", flush=True)
    n3 = _check_list_read("config 3", reader3, got, groups3)
    _same_at_one_worker("config 3", reader3, dev, wrappers, got,
                        launches, st)
    del got, groups3
    _routing("config 3", st, {"pages_device_snappy": 0,
                              "pages_device_delta_lanes": 0,
                              "pages_device_planes": 0})
    _need("config 3", launches, ["unpack_u32", "delta_scan",
                                 "levels_to_validity"])
    for k, c in launches.items():
        total_launches[k] += c
    _best_of("config 3", reader3, dev, n3,
             note=" (the JAX package: 139,788,640 on bench.py's own file)")
    del reader3, blob3

    # phase 3f: the sensor table, default transports
    t0 = time.perf_counter()
    blob_t, groups_t = build_sensors(args.values // 4 // g, g)
    print(f"sensor table: {g} row groups, {len(blob_t)} bytes, written in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    reader_t = FileReader(blob_t)
    got, launches, st = _drive(reader_t, dev, wrappers)
    print(f"sensor table launches: {launches}", flush=True)
    n_t = _check_read("sensor table", reader_t, got, groups_t)
    _same_at_one_worker("sensor table", reader_t, dev, wrappers, got,
                        launches, st)
    del got
    _routing("sensor table", st, {"pages_device_snappy": 0,
                                  "pages_device_delta_lanes": 0,
                                  "pages_device_planes": 0})
    _need("sensor table", launches, ["scatter_deltas", "bss_to_lanes",
                                     "delta_scan", "levels_to_validity"])
    _need_any("sensor table", launches, ["unpack_u32", "unpack_u64"])
    if launches["bss_to_lanes"] != 2 * g:
        raise AssertionError(f"sensor table: {launches['bss_to_lanes']} K12 "
                             f"launches, expected one per BSS page ({2 * g})")
    for k, c in launches.items():
        total_launches[k] += c
    _best_of("sensor table", reader_t, dev, n_t,
             note=" (the JAX package: 195,888,708 on the same generator)")
    check_plan_cache("sensor table", reader_t, dev, wrappers)
    del reader_t

    # phase 3g: the Spark-style table (INT96, BOOLEAN, FIXED_LEN_BYTE_ARRAY;
    # V1), default transports
    t0 = time.perf_counter()
    blob_k, groups_k = build_spark(args.values, g)
    print(f"spark table: {g} row groups, {len(blob_k)} bytes, written in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    reader_k = FileReader(blob_k)
    got, launches, st = _drive(reader_k, dev, wrappers)
    print(f"spark table launches: {launches}", flush=True)
    n_k = _check_read("spark table", reader_k, got, groups_k)
    _same_at_one_worker("spark table", reader_k, dev, wrappers, got,
                        launches, st)
    del got, groups_k
    _routing("spark table", st, {"pages_device_snappy": 0,
                                 "pages_device_delta_lanes": 0,
                                 "pages_device_planes": g})
    _need("spark table", launches, ["planes_to_words", "page_dict_fixed",
                                    "unpack_u32", "levels_to_validity"])
    for k, c in launches.items():
        total_launches[k] += c
    _best_of("spark table", reader_k, dev, n_k)
    del reader_k, blob_k

    # phase 3h: the parquet-mr v2 table (RLE booleans, DELTA_BYTE_ARRAY
    # strings and rows, DELTA_LENGTH_BYTE_ARRAY; data page V2), default
    # transports
    t0 = time.perf_counter()
    blob_v2, groups_v2 = build_mr_v2(args.values, g)
    print(f"parquet-mr v2 table: {g} row groups, {len(blob_v2)} bytes, "
          f"written in {time.perf_counter() - t0:.2f} s", flush=True)
    reader_v2 = FileReader(blob_v2)
    got, launches, st = _drive(reader_v2, dev, wrappers)
    print(f"parquet-mr v2 table launches: {launches}", flush=True)
    n_v2 = _check_read("parquet-mr v2 table", reader_v2, got, groups_v2)
    _same_at_one_worker("parquet-mr v2 table", reader_v2, dev, wrappers, got,
                        launches, st)
    del got
    _routing("parquet-mr v2 table", st, {"pages_device_snappy": 0,
                                         "pages_device_delta_lanes": 0,
                                         "pages_device_planes": 0})
    _need("parquet-mr v2 table", launches, ["levels_to_validity"])
    _need_any("parquet-mr v2 table", launches,
              ["unpack_u32", "expand_hybrid"])
    # one K8 launch per device-route DELTA_BYTE_ARRAY page (url, amount)
    # and one K13 launch per amount page; session pages assemble on the
    # host
    if (launches["expand_tokens"], launches["flba_bytes_to_lanes"]) != \
            (2 * g, g):
        raise AssertionError(
            f"parquet-mr v2 table: {launches['expand_tokens']} K8 and "
            f"{launches['flba_bytes_to_lanes']} K13 launches, expected "
            f"{2 * g} and {g}")
    by_column = _launches_by_column(reader_v2, dev, wrappers)
    print(f"parquet-mr v2 table row group 0 launches by column: "
          f"{by_column}", flush=True)
    want_k8 = {"url": 1, "session": 0, "amount": 1}
    if {k: by_column[k].get("expand_tokens", 0) for k in want_k8} \
            != want_k8 or by_column["amount"].get(
                "flba_bytes_to_lanes") != 1:
        raise AssertionError("parquet-mr v2 table: DELTA_BYTE_ARRAY pages "
                             "took other routes than the gate gives")
    for k, c in launches.items():
        total_launches[k] += c
    _best_of("parquet-mr v2 table", reader_v2, dev, n_v2)
    del reader_v2, blob_v2
    print(f"launches over the nine reads: {total_launches}", flush=True)

    # phase 3i: config 2 in ZSTD at full size, in GZIP and LZ4_RAW at a
    # fifth of it
    blob_z, codec_launches = codec_reads(groups, blob, snappy_read, dev,
                                         wrappers, args.values // 5)
    for launches in codec_launches.values():
        for k, c in launches.items():
            total_launches[k] += c

    # phase 5: the write path.  Each file's row groups are read on the
    # card, each column goes through as_values(), and the writer that
    # made the file writes them back from the card: byte for byte the
    # same file
    from tpuparquet_torch.io.writer import _write_threads

    print(f"encode workers: {_write_threads()} by default "
          "(TPQ_WRITE_THREADS, else the usable CPUs)", flush=True)
    sensor_enc = _encodings(SENSORS_ENCODINGS)
    dv_t = _device_groups(FileReader(blob_t), dev)
    launches = check_write("sensor table", blob_t, SENSORS_SCHEMA,
                           sensor_enc, dv_t, wrappers, 4 * g)
    _need("sensor table write", launches, ["pack_bits", "bss_encode_device",
                                           "delta_phase1", "lanes_min_max"])
    want = {"bss_encode_device": 2 * g, "delta_phase1": 2 * g,
            "lanes_min_max": 4 * g, "dict_build": 0}
    if {k: launches[k] for k in want} != want:
        raise AssertionError(f"sensor table write: launches {launches}, "
                             f"expected {want}")
    for k, c in launches.items():
        total_launches[k] += c
    _best_write("sensor table write from DeviceValues", lambda: _write(
        SENSORS_SCHEMA, dv_t, None, column_encodings=sensor_enc), n_t)
    _best_write("sensor table write from numpy", lambda: _write(
        SENSORS_SCHEMA, groups_t, None, column_encodings=sensor_enc), n_t)
    del blob_t
    # config 2: device_dict_build's range gate (KE5) on all five columns;
    # four pass it and intern (KE4), the size gate then drops
    # trip_distance_mm's dictionary, and pickup_ts and trip_distance_mm
    # write PLAIN from the card, their statistics by KE5
    dv_2 = _device_groups(reader, dev)
    launches = check_write("config 2", blob, SCHEMA, None, dv_2, wrappers,
                           2 * g)
    want = {"dict_build": 4 * g, "lanes_min_max": 7 * g, "pack_bits": 0,
            "bss_encode_device": 0, "delta_phase1": 0}
    if {k: launches[k] for k in want} != want:
        raise AssertionError(f"config 2 write: launches {launches}, "
                             f"expected {want}")
    for k, c in launches.items():
        total_launches[k] += c
    # config 2's writes from DeviceValues and numpy at the default and one
    # encode worker, timed with the native page path on and off
    check_native_writes(groups, dv_2, n_values)

    # phase 5b: ZSTD writes at 1 and the default encode workers, and a
    # page body split into frames
    launches = codec_writes(groups, blob_z, dev, wrappers, n_values)
    for k, c in launches.items():
        total_launches[k] += c
    del blob_z
    print(f"launches over the reads and writes: {total_launches}",
          flush=True)

    # phase 6: the sharded scan over config 2's and config 4's files, on
    # the 1x1 default mesh (6a, 6b) and a 2x2 mesh of four slots on the
    # card (6c); then sharded_dict_decode on both (6d)
    t_shard = time.perf_counter()
    meshes = shard_meshes(dev)
    g2 = [(c, {"payment_type": m}) for c, m in groups]
    files = (("config 2", blob, g2, list(groups[0][0]), []),
             ("config 4", blob4, groups4, ["fare", "tip"],
              ["vendor", "note"]))
    scans = {}
    for mlabel, mesh in meshes:
        for flabel, fblob, fgroups, fixed, byte_cols in files:
            phase = {("1x1", "config 2"): "6a", ("1x1", "config 4"): "6b"}
            label = f"{phase.get((mlabel, flabel), '6c')} {flabel} {mlabel}"
            n_f = n_values if flabel == "config 2" else n4
            got = check_sharded_scan(label, mesh, fblob, fgroups, fixed,
                                     byte_cols, dev, wrappers, n_f)
            _need(label, got["launches"], ["scatter_to_dense", "place_rows"]
                  + (["byte_densify"] if byte_cols else []))
            for k, c in got["launches"].items():
                total_launches[k] += c
            if mlabel == "2x2":
                _same_as_first(label, got, scans[("1x1", flabel)])
                del got["results"]
            scans[(mlabel, flabel)] = got
    streams_by_col = dict_index_streams(reader)
    if not streams_by_col:
        raise AssertionError("config 2 holds no dictionary-encoded column")
    c2 = scans[("1x1", "config 2")]
    for mlabel, mesh in meshes:
        label = f"6d sharded_dict_decode {mlabel}"
        launches = check_dict_decode(label, mesh, streams_by_col,
                                     c2["results"], wrappers)
        want = len(streams_by_col) * mesh.devices.size
        if launches["spmd_step_slot"] != want:
            raise AssertionError(f"{label}: {launches['spmd_step_slot']} KS2 "
                                 f"launches, expected one a slot ({want})")
        for k, c in launches.items():
            total_launches[k] += c
    print(f"phase 6 (the sharded scan): {time.perf_counter() - t_shard:.2f} "
          "s", flush=True)

    # phase 7: the multi-process scan of config 2's file, two processes
    # on the card
    launches = check_multihost(blob, c2["results"], c2["run_s"], n_values,
                               dev)
    for k, c in launches.items():
        total_launches[k] += c

    # phase 8: consumer meshes (8a), the resilient ladder under injected
    # faults (8b), the quarantine mode's wall (8c)
    t8 = time.perf_counter()
    one = meshes[0][1]
    launches = check_consumer_meshes(
        "8a consumer meshes", one,
        [("config 2", c2, list(groups[0][0]), []),
         ("config 4", scans[("1x1", "config 4")], ["fare", "tip"],
          ["vendor", "note"])], reader, dev, wrappers)
    _need("8a consumer meshes", launches,
          ["scatter_to_dense", "byte_densify", "place_rows"])
    for k, c in launches.items():
        total_launches[k] += c
    launches = check_resilient("8b config 2", one, blob, c2["results"], dev,
                               wrappers)
    _need("8b config 2", launches, CONFIG2_KERNELS)
    for k, c in launches.items():
        total_launches[k] += c
    time_resilient("8c config 2", one, blob, dev, c2["run_s"])
    print(f"8c: no un-faulted path of phases 3-8 moved {list(LADDER)} "
          f"({len(LADDER_CHECKED)} paths checked)", flush=True)
    print(f"phase 8 (consumer meshes, the resilient ladder): "
          f"{time.perf_counter() - t8:.2f} s", flush=True)

    # phase 9: filtered reads of config 2 in split pages (9a, 9b), the
    # bloom level (9c) and filtered scans (9d)
    launches = check_filtered(dev, args.values, g, wrappers,
                              strings=(blob_s, groups_s))
    _need("9d filtered scans", launches, ["scatter_to_dense",
                                          "byte_densify"])
    for k, c in launches.items():
        total_launches[k] += c
    del blob_s

    # phase 10: torn-file salvage and strict metadata (10a, 10b), hedged
    # replica reads (10c), decode_chunk_device (10d)
    launches = check_robustness(blob, groups, c2["results"], one, reader,
                                dev, wrappers, c2_pass_s)
    for k, c in launches.items():
        total_launches[k] += c

    # phase 11: the nested write (11a), a traced pass with the event log
    # and the device busy share (11b), a quarantine scan's post-mortem
    # and trace file (11c)
    launches = check_telemetry(blob, reader, one, dev, wrappers, args.values,
                               g)
    for k, c in launches.items():
        total_launches[k] += c

    # phase 12: a sharded scan of config 2 with every switch of the
    # telemetry's second part armed (progress, ledgers, digests, the ring,
    # the profiler, SLOs and alerts)
    launches = check_armed_scan(blob, one, dev, wrappers, n_values,
                                want_staged=snappy_read[1].bytes_staged)
    for k, c in launches.items():
        total_launches[k] += c

    # phase 13: two tenants' scans of config 2 at once under the serve
    # arbiter's shares, admission control and the rebalance
    walls13: dict = {}
    launches = check_arbiter(blob, c2["results"], one, dev, wrappers,
                             walls=walls13)
    for k, c in launches.items():
        total_launches[k] += c

    # phase 14: config 2 through emu:// and http:// sources and the range
    # caches, cold and warm (14a, 14b), two processes over one shared
    # disk tier (14c), and a DatasetScan of hive partitions (14d)
    launches = check_remote(blob, groups, reader, one, dev, wrappers,
                            c2_pass_s)
    for k, c in launches.items():
        total_launches[k] += c

    # phase 15: config 2 through the scan server (15a), its drain and
    # resume (15b), its prefetch over emu:// (15c) and plan cache (15d),
    # and the command-line tool's verify, serve, tenants and meta (15e)
    launches = check_server(blob, c2["results"], reader, one, dev, wrappers,
                            walls13["pair"])
    for k, c in launches.items():
        total_launches[k] += c

    # phase 16: config 2 hive-partitioned by rate_code through the
    # DatasetWriter (16a), a commit killed at its first promote and
    # resumed (16b), compaction through the CLI with filtered scans before
    # and after (16c), and floor's Trip objects (16d)
    for launches in (check_dataset(groups, one, dev, wrappers),
                     check_floor(groups, dev, wrappers)):
        for k, c in launches.items():
            total_launches[k] += c

    # phase 17: config 2 read, scanned over emu:// and served in a child
    # under the strict lock-order recorder and the profiler (17a), and
    # the port's analyzer through parquet_tool (17b)
    launches = check_lockcheck(blob, groups, args.values, g, dev, wrappers,
                               smi_line)
    for k, c in launches.items():
        total_launches[k] += c

    # phase 4: kernel times at the main paths' shapes
    kernels = time_kernels(groups, mix_groups, groups4, groups_s, groups_t,
                           groups_v2, dev, total_launches)
    kernels += time_encode_kernels(dv_t, dv_2, dev, total_launches)
    kernels += time_shard_kernels(c2, scans[("1x1", "config 4")],
                                  streams_by_col, dev, total_launches)
    _need("the main paths", total_launches, list(wrappers))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
