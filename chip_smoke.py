"""Smoke run of the PyTorch port (matrix_fhe_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main paths at the bench shape of the JAX package
(bench.py: logN = 14, 19 q-limbs + 3 p-limbs of primes < 2^23, rescale by
two primes, 8 hoisted rotations):

1. device: requires CUDA (exits non-zero without it) and prints the card's
   name and power limit as nvidia-smi reports them;
2. build: compiles the kernels from this checkout, started together, one
   nvcc for each library: csrc/ntt.cu (B1-B3) for each N the path runs
   (2^14, and 2^10 for phase 7), csrc/ntt64.cu (B4) for each N phases 10,
   17 and 21 run, csrc/ntt3n.cu (B5, one library for all N) and
   csrc/ntt_sharded.cu (B6, one library for all N), so that phase 26's
   ranks only load them;
3. kernel vs plain: at every NTT shape of the step, the kernel's forward and
   inverse are bit-identical to the plain torch version run on CPU copies,
   inverse(forward(x)) == x, and both versions are timed on the card; the
   cluster size C the wrapper picks for the shape is printed, and beside the
   kernel's time its device time with the launches queued back to back, with
   L2 flushed before each launch (as the step finds it), and the wrapper's
   host time a call;
4. main path: three requests, each one mul_relin_rescale and one
   rotations_hoisted over the 8 galois elements, served from a synthetic
   context on the card.  The first request's outputs hash to the digests
   the JAX package gives for the same call (tools/port_reference_digest.py),
   every request equals the same step on the CPU through the plain path, and
   the NTT kernel is launched the expected number of times per request.

Then the NTT-throughput path of the JAX package (bench.py:50-98) and the
w22 transform:

5. chain kernel vs plain: at [8, 3, 2^14] with k = 3, the chained transform
   (ntt_cuda.ntt_chain) forward and inverse is bit-identical to the plain
   version on CPU copies, and inverse-chain(forward-chain(x)) == x;
6. NTT path at bench width: over [24, 10, 2^14] the forward and the inverse
   chain of k = 500 transforms, one launch each, and the per-launch
   transform over [64, 10, 2^14] (bench.py's dispatch form), on bench.py's
   primes and operands.  The forward chain equals 500 sequential ntt_fwd
   launches and the plain chain, the inverse chain returns x, and the rates
   (NTTs per second) of both forms are printed beside the card, with the
   chain kernels' instructions a butterfly in their hot pass and their
   registers and spills (tools/ntt_sass.py, from the built SASS);
7. w22 transform (ntt_w22, the v1 kernel's counterpart, q < 2^22): a
   forward and inverse over [8, 4, 2^14] (tests/test_pallas_ntt.py's shape)
   returns x, and at that shape and at [2, 3, 2^10] the kernel is
   bit-identical to the plain version.

Then the setup path and a real CKKS session, the second main path:

8. int64 words wrap (* + -) and shift (>>) on the card as on the CPU (the
   u64 path holds 64-bit words in int64).  Then one session at the bench
   shape through the user's entry points, with real keys: the parameters
   (scale 2^45), the secret, relinearization and 8 galois keys (rotations
   by 1..8), FastEncoder.encode + encrypt of two vectors of 8192 complex
   slots, FastEvaluator.mul_relin then rescale twice, rotate_hoisted over
   the 8 rotations, decrypt + decode + precision_stats; each stage timed
   (host clock around work ending in a synchronize) in a first, cold pass
   (the per-level contexts and the caching allocator's blocks made on first
   use) and again in a warm pass with the same seeds, and the cold pass's
   peak device memory.  Every draw comes from a CPU generator of its own seed.
   Checks: B1 launched the expected number of times for the multiply and
   for the rotations (counts zeroed before each, read after) in both
   passes, and the warm pass gives the cold pass's keys and outputs; the
   product
   equals fckks.mul_relin_rescale on make_context's keys; the decoded
   product and rotations reach the precision floor (the JAX package's, less
   1 bit, tools/port_precision_floor.py); and the same code on the CPU with
   the same seeds gives the same secret and relinearization keys, the galois
   keys of rotations 1 and 2, both ciphertexts, the product, the rotations
   (from the card's galois keys) and the decoded values, bit for bit.

Then bootstrapping, the third main path:

9. one bootstrap session at logN = 14 through the user's entry points, on
   fboot.FAST_N14 (17 + 3 primes < 2^23, 8192 slots, an ephemeral sparse
   secret of weight 32, so the encapsulation keys run): keygen (the secret
   key, then gen_evaluation_keys in its two parts: the draws of the
   relinearization key, the 31 galois keys, the sparse secret and the two
   encapsulation keys on a CPU generator, and the deterministic part),
   make_fast_bootstrapper (the 6 DFT matrices encoded and converted to
   int32), encode + encrypt of 8192 complex slots
   (tools/port_precision_floor.py:boot_vector) at the residual level, bootstrap,
   evaluate(iterations=2) (META-BTS), decrypt + decode; a cold pass, then a
   warm pass with the same seeds that must give the same keys, outputs and
   B1 launches, and 3 more warm bootstraps (median).  Checks and prints:
   the output's level and scale; B1's launches for one bootstrap and for
   evaluate (counts zeroed before, read after); the session's peak device
   memory; the decoded precision of both (mean and min bits; no floor: the
   JAX package decodes this preset to noise too); the stage-by-stage
   decryption (after ScaleDown, ModUp, CoeffsToSlots, EvalMod and
   SlotsToCoeffs, each against what that stage computes on its actual input
   and against what the bootstrap should hold there), whose composition
   must equal bootstrap; the DFT round trip at input scales 2^15 and 2^34 and
   EvalMod on the bootstrap's keys, each against the JAX package's precision
   on the CPU (tools/port_precision_floor.py), the 2^34 round trip and
   EvalMod held to it less 1 bit (mean); B1 at every shape the bootstrap
   gives it, bit-identical to the plain version, with its cluster size and
   device time; and the same session on the CPU from the same seeds (a
   worker process, the plain NTT): its keys equal to the card's (by
   digest), its input, bootstrap and evaluate equal to the card's limb for
   limb and in the decoded values (checked after phase 25).

Then the wide path (41-61-bit primes, 64-bit words) and kernel B4, the NTT
of 64-bit words (csrc/ntt64.cu), which phases 8 and 9 now run too (every
u64 ring NTT on the card; their card == CPU checks hold it against the
plain NTT on the CPU, and its launches there are printed):

10. B4 alone: bit-identical to its plain version (the torch-op u64 NTT of
    ops/rings.py) forward and inverse at N = 2^6, 2^10, 2^14, 2^15 and 2^16
    on 45-, 55- and 61-bit primes, rows [1, 1], [1, 9] and [2, 21], at the
    cluster size the rule picks and at every size the kernel is built for
    (against the CPU's plain version too for one row), and at N = 2^14 on
    the wide61 P (bench.py's, its first prime above 2^61) at rows [2, 2],
    with its device time there at the cluster size the rule picks; the
    instructions a
    64-bit butterfly of its hot pass, registers and spills
    (tools/ntt_sass.py); and, after phases 11-13, bit-identical at every
    shape they gave it, with its times at the PN14QP438 step's shapes (the
    kernels-line time, the device time queued, L2 flushed, the wrapper's
    host time, the plain version's time) beside the bound;
11. the wide step at bench.py's two wide shapes (PN14QP438: 55 + 45x6-bit
    Q, 55x2-bit P; wide61: 60 + 45x5-bit Q, 61x2-bit P, the first P prime
    above 2^61), logN 14, each
    with 8 galois keys: three requests of mul_relin_rescale and
    rotations_hoisted over the 8 elements, B4 launches a request, the median
    of 10 more, the first request's digests equal to the JAX package's
    (tools/port_reference_digest.py wide), and every request equal to the
    same step on the CPU (the plain NTT; a worker process, by digest);
12. one wide bootstrap at fboot.wide_parameters_literal(14) (17 + 2 primes
    of 45-56 bits, 8192 slots, sparse secret weight 32) through the user's
    entry points, cold and warm as phase 9: keygen (draws and deterministic
    part), make_wide_bootstrapper, encode + encrypt, bootstrap (cold, warm,
    3 more), decrypt + decode; B4 and B1 launches a bootstrap, peak device
    memory, the stage-by-stage table, the same session on the CPU from the
    same seeds (a worker process) with keys, input and bootstrap equal to
    the card's limb for limb and decoded (checked after phase 25), and the
    decoded precision held to the JAX package's criterion for this chain
    (tests/test_wboot.py: mean >= 15 bits, min >= 5);
13. the comparison and inverse circuits on the wide evaluator at logN 14
    (tests/test_comparison_inverse.py's chain: 60 + 45x18-bit Q, 61x2-bit P,
    scale 2^45, relinearization and inverse galois keys): sign, step, max,
    min, goldschmidt_division and evaluate_positive_domain on 8192 slots
    drawn as that test draws them, within its bounds, each equal to the
    same circuit on the CPU from the same seeds, keys included (a worker
    process; checked after phase 25).  Then B4 by launch shape
    over the cold passes of phases 8, 9 and 11-13 (every call on the card
    recorded with its shape and counted, merged over moduli): launches,
    device time queued, bound and loss, launches x (device - bound), with
    the sum (b4_loss).

Then the fork's own rings and kernel B5, the 3N ring's NTT (csrc/ntt3n.cu,
a mixed-radix FFT), and the conjugate-invariant (CI) ring over B4's CI mode:

14. B5 alone: at N = 6 (no factorized split: the dense transform runs and
    B5 is launched no time), 48, 96, 1152, 1536, 12288, 24576 and 27648 (the
    largest one CTA holds) on 45-, 55- and 60-bit 3N primes over
    [2, 3, N], bit-identical to its plain version (ops/ntt_3n.py) on the
    card at the cluster size the wrapper picks and at every size it takes
    (1, 2, 4, 8) and, for one row, on the CPU, forward and inverse, and
    inverse(forward(x)) == x; at N = 12288 over phase 15's 7 primes, the
    forward and inverse of a numpy-seeded [2, 7, N] input hash to the JAX
    package's digests (tools/port_reference_digest.py 3n); the instructions
    a butterfly of its hot radix-2^k pass and a radix-3 butterfly, registers
    and spills of each kernel (tools/ntt_sass.py --b5); and,
    after phase 15, bit-identical at every shape phase 15 gave it, with its
    times there (the kernels-line time, the device time queued, L2 flushed,
    the wrapper's host time, the plain version's time) beside the bound;
15. a Matrix-CKKS session at N = 12288 = 2^12 3 through the user's entry
    points (schemes/matrix_ckks): 50 + 40x5-bit Q, a 60-bit P (3N primes,
    all below 2^61), scale 2^40; keygen (the secret, relinearization and
    galois keys for 5 and 3N - 1: the draws on CPU generators and the
    deterministic part, timed apart), encode + encrypt of two vectors of N
    reals from default_rng(0), then add, mul_const(0.5) + rescale,
    mul_relin + rescale and the two automorphisms, each once (B5 launches
    counted) and as the median of 10 more, decrypt + decode: each held to
    max |error| <= 0.1 (tests/test_matrix_ckks.py's tolerance) against the
    numpy model (the ring product mod X^N - X^{N/2} + 1, the map X -> X^g),
    its error printed in bits; peak device memory; and the same session on
    the CPU from the same seeds (a worker process) equal to the card's,
    keys (by digest), limb for limb and decoded;
16. CKKS on the CI ring at logN 14 (55 + 45x6-bit Q, a 61-bit P, scale
    2^45, 16384 real slots from default_rng(0); tools/port_precision_floor.py
    ci's literal and vectors): keygen, encode + encrypt, mul_relin +
    rescale and a rotation by one slot, decrypt + decode, with B4's
    launches on the CI ring at each (the standard ring's none), the min
    precision held to the JAX package's less 1 bit, and the same code on
    the CPU from the same seeds (a worker process) equal to the card's,
    keys (by digest) included; then B4 on the CI ring
    (ntt64_cuda.ntt_ci_fwd / ntt_ci_bwd: the kernel's CI mode, the fold in
    its load and store) bit-identical to its plain version at every shape
    the session gave it, one kernel a call there (three calls captured
    into a CUDA graph hold three B4 kernel nodes and nothing else) and no
    torch operator but the output's allocation (a dispatch mode),
    with its times there (as B5's) beside the bound, and its loss table
    by shape as phase 13's; then the loss summed over phases 8-13 and 16,
    and every shape of those tables with its launches and moduli written
    to matrix_fhe_tpu_torch/_build/b4_shapes.json (for
    tools/ntt64_ab.py --shapes).

Then ring switching, ring packing, the standard <-> CI bridge, the packed
and sparse bootstrap and BGV / BFV, all on B4 (its standard and CI modes):
each phase runs through the user's entry points in a cold and a warm pass
(the same seeds; the warm pass must give the cold pass's keys and outputs),
prints each stage's latency in both, and holds its outputs to the same
calls on the CPU (the card's inputs and keys, the plain NTT; phase 20: the
same session from the same seeds; both in a worker process):

17. ring switching and packing at logN 12-14 on PN14QP438's chain (7 + 2
    primes of 45-55 bits): gen_ring_swap_keys between logN 13 and 14,
    switch_up of 8192 integer coefficients in [-50, 50) at scale 2^30 and
    switch_down back (every coefficient within 0.01); expand of 16 values at
    stride 2^10 at logN 14 (log_gap 10, its 28 galois keys) and pack of the
    16 outputs (0.01 / 0.05); a RingPackingEvaluator(12, 14): split and
    merge at 14, extract -> repack of the 16 indices at stride 2^10 in the
    pairings (full, full), (naive, full), (full, naive) (0.05, repack
    0.2: tests/test_ring_packing*.py's bounds); the noise of both ring-swap
    keys (rlwe/noise.py); card == CPU for switch_up, switch_down, expand,
    pack, split, merge and the monomials;
18. the bridge between the standard ring at logN 15 and phase 16's CI ring
    (its chain and CI keys): the swap keys, one standard ciphertext of 16384
    reals, complex_to_real, a CI mul_relin + rescale, real_to_complex (and
    the direct return); precision floors 15 / 12 bits (tests/test_bridge.py);
    card == CPU for both switches;
19. on phase 12's keys and wide bootstrapper (no second bootstrapper):
    the galois keys of galois_elements_for_packed_bootstrap(params, 2),
    bootstrap_packed of two ciphertexts of np.tile(v, 2) (v of 4096 values),
    equal to its pack, bootstrap and expand run apart, and bootstrap_sparse
    of two logN-13 ciphertexts through their ring-swap keys; min precision
    above 8 and 7 bits (tests/test_boot_packed.py); card == CPU for the pack
    into the bootstrap, the expand out of it and a switch_up;
20. BGV and BFV at logN 14, T = 65537 (examples/bgv_template.py:25's chain,
    55 + 45x2-bit Q, a 61-bit P): keys (relinearization, the column and row
    rotations, the 4-diagonal linear transformation's), encode + encrypt of
    two vectors of 16384 slots, add, mul_relin + rescale (BGV), mul_relin
    (BFV), rotate_columns(1), rotate_rows, a bgv_circuits linear
    transformation of 4 diagonals and a degree-7 Paterson-Stockmeyer
    polynomial (BFV: the chain has 2 levels), each decoded and equal to
    numpy mod T; the relinearization key's noise; card == CPU for both
    encryptions and every result.
Then B4 against its plain version at every shape phases 17-20 gave it
(N = 2^12-2^15; on the CI ring with one kernel a call), and its loss table
over them.

Then RGSW, blind rotation and the multiparty protocols, on B4, run the same
way (cold and warm pass, held to the same calls on the CPU with the same
generator seeds, bit for bit):

21. (a) on PN14QP438's chain at logN 14 (7 + 2 primes, scale 2^45): RGSW(3)
    and RGSW(X^5) with the standard gadget and RGSW(3) with a P-less
    base-two gadget (B = 12) on the same Q, each times a fresh encryption
    of 8192 real slots (external_product), within tests/test_rgsw.py's 12
    bits (min) against 3 v and the negacyclic shift, and
    tests/test_base2.py:97's 10 bits (mean) against 3 v; (b) the blind
    rotation at the reference example's ring size: ring logN 10 (a 27-bit
    Q and a 31-bit P prime), LWE logN 9 (a 14-bit prime, ternary secret of
    density 2/3), gen_evaluation_key in its two parts (512 RGSW + 11
    galois keys), sign(x) over the 4 slots -0.75, -0.3, 0.4, 0.8, each
    within 0.1 (tests/test_blindrot.py's bound); the time and B4's
    launches a slot;
22. tests/test_multiparty.py's protocols among 3 parties at logN 14: the
    collective public key (15 bits), galois key for a rotation by one
    (12), relinearization key in two rounds (10 on v^2), KeySwitch to a
    fresh collective key (12) and PublicKeySwitch to a public key (10),
    the 2-of-3 threshold sharing (parties 1 and 3 recombine the ideal
    secret exactly), the refresh from level 0 to the top (10) and with
    the slot transform z -> -z (8), on PN14QP438's chain; the BGV refresh on
    phase 20's chain, exact mod T; each protocol's latency, the host time
    of the Python-integer parts (masks, CRT, Lagrange coefficients) and the
    peak device memory.
Then B4 against its plain version at every shape phases 21-22 gave it
(N = 2^9, 2^10, 2^14), its loss table over them, and its summed device
time against the cold passes' wall time.

Then the user-facing surface, on B4 (its standard mode at 2^5-2^14 and its
CI mode at 2^6), each held to the same calls on the CPU from the same seeds
(a worker process, the plain NTT):

23. the flagship step (flagship.py) at PN14QP438, none cut: logN 14, 9 q-
    and 1 p-limb (55 + 45x8 and 61 bits), scale 2^45: build_flagship's two
    parts timed (the draws on a CPU generator; the keys, encode and
    encrypt), build_flagship itself giving the same objects, then
    make_step's rescale(mul_relin) for 3 requests and the median of 10
    more (host clock around work ending in a synchronize), each equal to
    the first; B4 launches a step, peak device memory, the decoded min
    precision held to tests/test_ckks.py:90-97's 20 bits; the step's
    output and decoding equal to the CPU's;
24. serialization (utils/serialization.py) at that width: phase 23's
    parameters, secret and relinearization keys and two ciphertexts, 8
    galois keys (rotations 1-8) and an RGSW(3), each saved to a file in a
    temporary directory under the build directory and loaded back to the
    card (bytes, save and load times, MB/s); the reloaded objects equal
    the saved ones and run the step bit-identically; every blob's sha256
    equals the CPU worker's blob of the same object; and the card's
    encoder reproduces tests/test_serialization.py:105's plaintext digest;
25. the 14 examples (matrix_fhe_tpu_torch/examples, the JAX scripts'
    circuits at their own sizes, logN 5-8), each main(device="cuda")
    passing every assert of its script, printing its wall time and B4
    launches, and returning what the same call on the CPU returns: the
    decrypted words bit for bit and the decoded values.
Then B4 against its plain version at every shape phases 23-25 gave it
(on the CI ring with one kernel a call), and its loss table over them.

Then the multi-device code (parallel/, multiparty/mesh.py), each rank a
process (parallel/launch.py), on the one card:

26. kernel B6 (csrc/ntt_sharded.cu, the sharded NTT's local step) against
    its plain version on the card, bit for bit, at every block of the
    k = 8, 2 and 1 shard shapes of a [2, 10, 2^14] input on the
    flagship's 9 Q primes and 61-bit P, timed as B4 is (kernels line,
    queued, L2 flushed, host) beside its bound, with the geometry the
    rule gives each block, ptxas's registers and spills and the SASS
    instructions a multiply-accumulate of each product's hot loop
    (tools/ntt_sass.py --b6); then a world of 8 ranks over gloo (each rank on cuda:0, the
    collectives through host memory): ntt_sharded over all 8 and over the
    2 of a 4 x 2 mesh, each gathered output == B4's Ring.ntt; the
    limb-sharded step at make_synthetic_context(14, 16, 3) (bench.py's
    (14, 19, 3) with L cut to 16, which 8 divides) over 8 ranks, on a
    [3, 16, 2^14] batch over 8, and on a batch of 2 over a 2 x 4 (batch x
    limb) mesh, each == fckks.mul_relin_rescale on the card with the
    dropped limbs zero; the collective public key of 8 parties at logN 14
    (9 + 1 primes of 45 bits) == the sequential gen_share / aggregate /
    finalize, a vector encrypted under it decrypting under the sum of the
    secrets to >= 10 bits; the collective counts (1 all-to-all; 1
    all-gather + 2 psums; 2 psums) and the kernels' launches of each rank;
    then the same in a world of 1 rank over NCCL; each sharded call's wall
    time, the median of 5 after a warm call of the slowest rank (k
    processes sharing one card: no scaling).  Each rank records every
    (direction, shape, moduli) it gives B1 and B4 and every block it gives
    B6; B1 and B4 are then held to their plain versions at each, and B6
    must have run only at blocks held above.  Their launches in the ranks
    join the kernels line's launches_by_path.

27. the staged bootstrap (circuits/ckks/staged.py: one CUDA graph a stage,
    captured at its first call and replayed) on phase 9's fast session
    (run right after phase 9, no new keygen) and on phase 12's wide one
    (right after phase 13): the first call's time split into its eager
    warm-up, the capture with the graph's instantiation, and the replays;
    phase 9's (12's) input and a second one of the same level and scale
    (another vector, encrypted in the same session) each equal to
    bts.bootstrap on the card bit for bit; each stage equal to the same
    stage run eagerly (run_stages(eager=True)) on both inputs, and head,
    c2s_tail and the last stage equal to boot_stages' ModUp,
    CoeffsToSlots and SlotsToCoeffs; the B1 and B4 kernel nodes of the
    graphs, each counted as often as a bootstrap replays it (utils/
    launches.py:graph_nodes), equal to the eager bootstrap's launches; no
    wrapper launch in a replayed bootstrap; the median of 5 staged
    bootstraps (host clock around work ending in a synchronize) and their
    device time queued, beside phase 9's (12's) eager warm median; the
    graphs and replays a bootstrap, and the peak device memory.
Then the reference's production bootstrap, the largest configuration a
user of the library runs:

28. the wide bootstrap at fboot.wide61_parameters_literal(16, 5, 32, 4):
    logN 16, 2^15 slots, the reference's N16QP1547 widths (60-bit q0, 45-,
    42-, 58- and 60-bit primes, 19 in Q, four 61-bit P primes), sparse
    secret weight 32, 39 galois keys, none cut: keygen (draws on CPU
    generators seeded as phase 12's, then the deterministic part),
    make_wide_bootstrapper, two inputs of 2^15 complex slots from
    default_rng(0) encrypted at the residual level; bootstrap cold, warm and
    the median of 3 more; the stage table as phase 12's; the staged
    bootstrap on the same bootstrapper as phase 27 runs it (first call split
    into warm-up, capture and replays, the median of 5 and its device time
    queued, graphs, replays and B4's kernel nodes); one u64 bootstrap
    (btp.Evaluator) on the same keys and first input; the peak device
    memory of the session and the graphs' pool.  Gates: (a) the wide
    bootstrap equals the u64 one limb for limb; (b) the staged bootstrap
    equals the eager one bit for bit on both inputs; (c) the decoded
    precision of both, eager and staged, meets the JAX package's criterion
    (mean >= 15 bits, min >= 5); (d) B4 equals its plain version at every
    (direction, shape, moduli) the phase gave it, all at 2^16; (e) the
    CoeffsToSlots and SlotsToCoeffs matrices hash to the JAX package's
    (tests/test_torch_wboot.py's n16_dft_matrices, pinned by
    tools/port_circuit_digests.py); (f) no wrapper launch in a replayed
    bootstrap.  No CPU reference: the plain path cannot bootstrap at 2^16
    within the script's limit.  B4 is the only kernel on this path (B1 runs
    only on the fast path; B2, B3, B5 and B6 are off it).  Its loss table
    joins the others and b4_shapes.json.

From phase 8 on, every key switch and every default-gadget keygen of the
u64 evaluator runs through the key-switch graph caches (rlwe/evaluator.py
_pgraph, rlwe/keys.py _EVK_GRAPH_CACHE, on utils/graphs.py): one CUDA
graph a (name, parameters, level) and input signature, captured at its
first call and replayed after, so the earlier phases' card == CPU gates
hold the graphed path to the eager one on the CPU.  Run after phase 25:

29. the key-switch graph caches on the sessions of phases 23 (the flagship
    step and a rotation by each of its 8 galois keys), 21 (one
    blind-rotated slot), 15 (Matrix-CKKS mul_relin + rescale), 16 (CI
    mul_relin + rescale) and 8 (its 8 galois keys' deterministic part).
    For each, with both caches emptied first: the first call (its eager
    warm-ups and captures apart), graphed == eager (the same call within
    utils/graphs.py eager()) bit for bit on the first and a second call,
    and == the earlier phase's output; each graph's kernel nodes by name
    == a capture of its eager body on its inputs, its B4 and B5 nodes ==
    the wrappers' launches in an eager run of the body, and B4's and B5's
    launches of an eager call == those of a graphed call outside the
    graphs plus the graphs' nodes times their replays; the eager and the
    graphed latency (median of 10, of 3 for the slot); the caches'
    entries, the shared pool's bytes and the peak device memory.  Alone:
    python tools/graph_phase.py.

Before the kernels line, one "phase time: <n> <seconds>" line a phase (a
phase's continuation, the B4 checks after its group, counts to it; the
builds to phase 2).

Prints a JSON line of per-kernel results, one entry per kernel entry point:
launches on its path (phase 4 for ntt_fwd/ntt_bwd, 6 for the chain, 7 for
w22; counts zeroed just before each run and read just after; ntt_fwd/ntt_bwd
also give launches_by_path: phase 4's, phase 8's cold pass, and phase 9's
bootstrap and evaluate apart; ntt64_fwd/ntt64_bwd, kernel B4, phase 11's
three PN14QP438 requests, with launches_by_path over phases 8, 9, 11, 12,
13, 17-25 and 28 (eager) and phases 27, 28 and 29's kernel nodes; ntt3n_fwd/ntt3n_bwd, kernel B5,
phase 15's operations, with launches_by_path over its keygen and each
operation and phase 29's kernel nodes; ntt64_ci_fwd / ntt64_ci_bwd, B4 on the CI ring, phase 16's
session, by stage, phase 18's CI side and phase 25's scheme switching;
ntt_sharded_local, kernel B6, the 8 launches of phase 26's 8-rank NTT, one a rank, with launches_by_path
over its worlds; B1's and B4's launches_by_path also count phase 26's
ranks), max
|kernel - plain| (phases 3 and 9 for B1, 10 for B4, 14 for B5, 16 for B4
on the CI ring), the kernel's and plain version's times (phase 3's shapes
summed, one launch each, for ntt_fwd/ntt_bwd; the PN14QP438 step's shapes
summed for B4; phase 15's shapes summed for B5 and phase 16's for B4 on the
CI ring, with their device, L2-flushed and host times beside; the path's
shape for the others), and the bound: the larger of the bytes over the
card's memory rate and the integer operations over its int32 rate (for B4
and B5, the 32-bit multiply-adds the function needs over the FMA pipe's
rate: see MULS_SHOUP and _b5_bound; the kernel's own SASS instructions a
butterfly, or for B6 a multiply-accumulate, are reported beside it).  Times in that line are CUDA-event
means of launches issued back to back from the host (_event_ms).  No single
PyTorch call computes a negacyclic NTT mod q, nor a 64-bit modular matrix
product (B6), so library_ms is null.  Then, as its last line,
{"ok": true, "device": {...}}.  Any failed check raises and exits non-zero.
The script imports no jax.

The CPU references of phases 9, 11-13, 15, 16 and 20-25 (CPU_REFERENCES)
are whole sessions rebuilt from their generator seeds, keys included, and
phase 17's runs the same calls on the card's inputs and keys, pickled over
(SHIPPED_REFERENCES).  They run in spawned worker processes started with
the script (CPUReferences: one for each two cores beyond the main
process's two, at most three), beside the card's phases, and are
terminated when it ends.  Phases 21-25 read theirs in place; the others
are checked after phase 25 (hold_to_cpu_references), and each one's wait
there counts to its phase.
"""

from __future__ import annotations

import contextlib
import hashlib
import importlib
import io
import json
import multiprocessing
import pickle
import statistics
import subprocess
import sys
import tempfile
import time
import types

import numpy as np
import torch

LOGN, NUM_Q, NUM_P, NUM_ROT, SEED = 14, 19, 3, 8, 0
# tools/port_reference_digest.py: the JAX package on the CPU, same call
MUL_RELIN_RESCALE_SHA256 = "54a57d651c2c489df7f6716e62e7749541871319469d9fe59d568cc024185523"
ROTATIONS_HOISTED_SHA256 = "b78881c6409abe820ebe6b32a2f780dbf5b4481f3637a5244d0557d0b1defc94"
# the TPU kernel each entry point replaces: ntt_fwd / ntt_bwd reach
# _transform (pallas_ntt2.py:304) and its pl.pallas_call, the chain is
# pallas_ntt2.ntt_chain, ntt_w22's reach _transform -> _call (pallas_ntt.py)
REPLACES = {"fwd": "matrix_fhe_tpu/ops/pallas_ntt2.py:352",
            "bwd": "matrix_fhe_tpu/ops/pallas_ntt2.py:357",
            "chain_fwd": "matrix_fhe_tpu/ops/pallas_ntt2.py:363",
            "chain_bwd": "matrix_fhe_tpu/ops/pallas_ntt2.py:363",
            "w22_fwd": "matrix_fhe_tpu/ops/pallas_ntt.py:294",
            "w22_bwd": "matrix_fhe_tpu/ops/pallas_ntt.py:299"}
SOURCE = "matrix_fhe_tpu_torch/csrc/ntt.cu"
# bench.py:64-74 and :86-88: the chain and the dispatch form of the NTT bench
BENCH_LIMBS, CHAIN_BATCH, CHAIN_K, DISPATCH_BATCH = 10, 24, 500, 64
# tests/test_pallas_ntt.py:51, and a small ring
W22_SHAPES = [(8, 4, 1 << 14), (2, 3, 1 << 10)]
# log2 N of every launch of the path: the step's and the NTT bench's, and w22's
PATH_LOGNS = sorted({LOGN} | {s[-1].bit_length() - 1 for s in W22_SHAPES})
# The bound.  Bytes: each input read once (x, the twiddles and their Shoup
# quotients), the output written once, at the H100 SXM's 3.35 TB/s.
# Operations: 7 integer operations a butterfly (a Shoup product is two
# multiplies and a high multiply; then an add, a subtract and a conditional
# subtract of two), (N/2) log2(N) butterflies a transform, at the SM's
# int32 issue rate at the card's maximum SM clock.  On compute capability
# 9.0 the multiplies run on the FMA pipe and the adds, compares and selects
# on the ALU pipe, 64 a clock each, so a mix of both issues at 128 a clock
# (4 schedulers x 32 lanes).  The per-element reductions are left out (< 5%).
# Phase 8, the real-key CKKS session: scale 2^45 (bench.py:150-153's pair
# budget: the two primes a pair of rescales drops, q18 q17, are 2^44.56),
# galois keys for rotations by 1..8, one CPU generator a draw site
SESSION_LOG_SCALE = 45
SESSION_ROTATIONS = tuple(range(1, 9))
# galois keys the CPU reference builds again (the rotations by 1 and 2); the
# other six are held through the rotations they give on the CPU
CPU_GALOIS = SESSION_ROTATIONS[:2]
# tools/port_precision_floor.py, the JAX package on the CPU with the same
# parameters and vectors (JAX's own keys and draws): min precision 30.9659
# bits for the product, 25.1012 for the worst of the 8 rotations.  The floor
# is 1 bit below.
PRECISION_FLOOR = {"product": 30.9659 - 1, "rotations": 25.1012 - 1}
# B1 launches: FastEvaluator.mul_relin (decompose 1 INTT + 2 NTT, ModDown
# 1 + 1), then two rescales (1 INTT + 1 NTT for each of the two parts);
# rotate_hoisted over G elements (decompose 1 + 2, ModDown 1 + 1 each)
SESSION_LAUNCHES = {
    "multiply": {"fwd": 3 + 4, "bwd": 2 + 4},
    "rotations": {"fwd": 2 + len(SESSION_ROTATIONS), "bwd": 1 + len(SESSION_ROTATIONS)}}
# Phase 9, bootstrapping at FAST_N14: warm repeats of one bootstrap, and the
# JAX package's decoded precision (mean, min bits over 8192 slots) of the
# bootstrap's circuits on the same parameters (tools/port_precision_floor.py
# bootstrap, on an 8-core CPU, JAX's own keys).  The round trip at the default
# scale 2^15 decodes to noise there too and is printed beside it; the floor
# holds the mean of the others to JAX's less 1 bit.
BOOT_REPEATS = 3
# Phase 27: the staged bootstrap's replays timed (the median is reported)
STAGED_REPEATS = 5
BOOT_JAX_PRECISION = {"dft round trip 2^15": (-9.3225, -11.5838),
                      "dft round trip 2^34": (9.6485, 7.3162),
                      "eval_mod": (0.0826, -6.3947)}
BOOT_FLOORS = ("dft round trip 2^34", "eval_mod")
HBM_BYTES_PER_S = 3.35e12
OPS_PER_BUTTERFLY = 7
INT32_OPS_PER_CLOCK_PER_SM = 128
# The operations bound of B4 and B5 (64-bit words) counts the 32-bit
# multiply-adds that the function needs, not the instructions the kernel's
# SASS spends (that count is printed beside it: the kernel's own cost, not
# the bound).  They run on the FMA pipe alone, 64 a clock on each SM, half
# the int32 rate above; the adds, carries and selects beside them issue on
# the ALU pipe and are left out.  With schoolbook 32 x 32 -> 64 partial
# products, a 64 x 64 -> 128 product takes 8 (the low and the high half of
# each of the 4), its low 64 bits 4, its high 64 bits 7 (the lowest half
# only carries).  A product by a fixed table word in Shoup form is a high
# half (the quotient) and two low halves (w x - quotient q).
MULS_LO, MULS_HI = 4, 7
MULS_SHOUP = MULS_HI + 2 * MULS_LO
# Phases 10-13, the wide path and kernel B4 (csrc/ntt64.cu): the TPU
# transform it replaces (wide_ntt.ntt_fwd / ntt_bwd, XLA int8 matmuls, not a
# pl.pallas_call), the sizes phase 10 checks it at, and bench.py's two wide
# step shapes (bench.py:214-216 and :292-293) with 8 galois keys for
# rotations_hoisted; their digests come from tools/port_reference_digest.py
# wide (the JAX package on the CPU, jitted, at logN 14, the same moduli).
B4_SOURCE = "matrix_fhe_tpu_torch/csrc/ntt64.cu"
B4_REPLACES = {"fwd": "matrix_fhe_tpu/ops/wide_ntt.py:286",
               "bwd": "matrix_fhe_tpu/ops/wide_ntt.py:290"}
B4_SIZES = (6, 10, 14, 15, 16)
# wide61: bench.py's Q and P at logN 14 (make_synthetic_context(14, 6, 2,
# q_bits=(60,) + (45,) * 8, p_bits=61)); P's first prime lies above 2^61
WIDE61_Q = (1152921504606748673, 35184372121601, 35184372744193, 35184373006337,
            35184371138561, 35184370941953)
WIDE61_P = (2305843009214414849, 2305843009211662337)
WIDE_SHAPES = {
    "pn14qp438": lambda wckks, dev: wckks.make_synthetic_context(
        LOGN, 0, 0, moduli=(wckks.PN14QP438_Q, wckks.PN14QP438_P), seed=SEED,
        num_rot=NUM_ROT, device=dev),
    "wide61": lambda wckks, dev: wckks.make_synthetic_context(
        LOGN, 0, 0, moduli=(WIDE61_Q, WIDE61_P), seed=SEED, num_rot=NUM_ROT, device=dev)}
# phase 11's three requests: the order of the four operands in each
WIDE_ORDERS = [(0, 1, 2, 3), (2, 3, 0, 1), (1, 0, 3, 2)]
WIDE_STEP_SHA256 = {
    "pn14qp438": ("22ec29b7c996268077d30019ce19f9d2ded8d0fec0a1c9867f9d54eb8b12c01d",
                  "96be3223eb1793738305db5d728e583cd5629b6d9f9722705804266358cba9c3"),
    "wide61": ("13b3a0b335258d936bdfc1b4a9af74f09b9c60eab2b62afdf016bfd9087c5b16",
               "63428ccbfe3c2ae7a0bce01cad07e49e71e3b8e5abd432d9c54d02e9b1aa2866")}
# Phase 12: the JAX package's criterion for the wide bootstrap
# (tests/test_wboot.py:50-76): decoded mean precision >= 15 bits, min >= 5
WIDE_BOOT_FLOOR = {"mean": 15.0, "min": 5.0}
# phase 28: wide61_parameters_literal(log_n, residual_levels, sparse_weight, num_p),
# the reference's N16QP1547 widths at logN 16 (tests/test_torch_wboot.py:N16)
N16_LITERAL = (16, 5, 32, 4)
# tools/port_circuit_digests.py test_torch_wboot:n16_dft_matrices: the JAX
# package's CoeffsToSlots and SlotsToCoeffs matrices there (dft_matrices_digest)
N16_MATRICES_SHA256 = "56e7bf3d243c16c731588da20bfe48b906b0ae29b8f9b5dfe1cf5cba1c251681"
N16_REPEATS = 3
# Phase 13: tests/test_comparison_inverse.py's bounds (max |error|; atol for
# Goldschmidt; atol + rtol |1/x| with 0.01 each for the inverse)
CIRCUIT_BOUNDS = {"sign": 0.1, "step": 0.1, "max": 0.05, "min": 0.05,
                  "goldschmidt_division": 1e-4, "evaluate_positive_domain": 0.01}
# Phases 14-16, the fork's rings and kernel B5 (csrc/ntt3n.cu): the TPU
# transform it replaces (ntt_3n.ntt_fwd / ntt_bwd, XLA u64 mod-matmuls, not a
# pl.pallas_call), the degrees phase 14 checks it at (N = 6 has no
# factorized split and runs the dense transform), its digests at N = 12288
# over phase 15's 7 primes (tools/port_reference_digest.py 3n, the JAX
# package on the CPU), phase 15's Matrix-CKKS literal and repeats, its bound
# (tests/test_matrix_ckks.py's tolerance), and phase 16's precision floors on
# the CI ring (tools/port_precision_floor.py ci, the JAX package on an 8-core
# CPU with its own keys and draws: min precision 28.8296 bits for the
# product, 29.1074 for the rotation; the floor is 1 bit below).
B5_SOURCE = "matrix_fhe_tpu_torch/csrc/ntt3n.cu"
B5_REPLACES = {"fwd": "matrix_fhe_tpu/ops/ntt_3n.py:213",
               "bwd": "matrix_fhe_tpu/ops/ntt_3n.py:234"}
B5_SIZES = (6, 48, 96, 1152, 1536, 12288, 24576, 27648)
# B4 on the CI ring: its wrapper's entry points and the CI transform they replace
CI_ENTRIES = ("ntt_ci_fwd", "ntt_ci_bwd")
CI_REPLACES = {"fwd": "matrix_fhe_tpu/ops/rings.py:430", "bwd": "matrix_fhe_tpu/ops/rings.py:455"}
NTT3N_SHA256 = {"fwd": "129191f786f063a8be246d1e8dc2f0801ea1a357f09f94e1dcb2c0e11d1f54d2",
                "bwd": "f4b62cc500dfe7f65dcaa1b5101cdc05e774af8fcc6c7b5e2482df0e58e7a3bb"}
MATRIX_LITERAL = dict(order2=12, order3=1, logq=(50, 40, 40, 40, 40, 40), logp=(60,),
                      log_default_scale=40)
MATRIX_REPEATS = 10
MATRIX_BOUND = 0.1
CI_FLOOR = {"product": 28.8296 - 1, "rotation": 29.1074 - 1}
# Phases 17-20: ring switching and packing at logN 12-14 on PN14QP438's chain
# (coefficients at scale 2^30; tests/test_ring_switch.py's and
# tests/test_ring_packing*.py's bounds), the bridge's and the packed and
# sparse bootstrap's floors (tests/test_bridge.py:45,50,
# tests/test_boot_packed.py:50,95), and BGV / BFV on
# examples/bgv_template.py:25's chain at logN 14 (4 diagonals, degree 7).
RS_LOGNS = (12, 13, 14)
RS_SCALE = 1 << 30
RS_LOG_GAP = 10
RS_PAIRINGS = {"full, full": (False, False), "naive, full": (True, False),
               "full, naive": (False, True)}
RS_BOUNDS = {"switch_up": 0.01, "switch_down": 0.01, "expand": 0.01, "pack": 0.05,
             "split": 0.05, "merge": 0.05, "extract": 0.05, "repack": 0.2}
BRIDGE_FLOOR = {"switch": 15, "return": 12, "product": 12}
PACKED_FLOOR = {"packed": 8, "sparse": 7}
BGV_LITERAL = dict(logn=14, t=65537, logq=(55, 45, 45), logp=(61,))
BGV_DIAGS = (0, 1, 2, 3)
BGV_POLY = [5, 3, 0, 1, 7, 0, 2, 4]   # tests/test_bgv.py's degree 7
# Phases 21-22: tests/test_rgsw.py's and tests/test_base2.py:97's products and
# bounds on PN14QP438's chain at logN 14; the blind rotation at the reference
# example's ring size ("reference uses LogN=10",
# examples/rgsw_blind_rotation.py:34), its values (:57) and
# tests/test_blindrot.py's bound; tests/test_multiparty.py's protocols among
# its 3 parties, with its bounds (min L2 precision, bits).
RGSW_BOUNDS = {"scalar": 12, "monomial": 12, "base2": 10}
RGSW_MONOMIAL = 5
RGSW_BASE_TWO = 12
BR_RING = (10, 27, 31)     # logN, Q bits, P bits
BR_LWE = (9, 14)           # logN, q bits
BR_VALUES = (-0.75, -0.3, 0.4, 0.8)
BR_BOUND = 0.1
MP_PARTIES = 3
MP_POINTS = (1, 2, 3)
MP_ACTIVES = [1, 3]
MP_THRESHOLD = 2
MP_LOG_BOUND = 40
MP_BOUNDS = {"public key": 15, "galois key": 12, "relinearization key": 10, "key switch": 12,
             "public key switch": 10, "refresh": 10, "refresh with transform": 8}
PHASE_NAMES = {"17": "ring switching and packing", "18": "bridge, the standard ring",
               "19": "packed and sparse bootstrap", "20": "BGV and BFV",
               "21a": "RGSW external products", "21b": "blind rotation",
               "22": "multiparty protocols", "23": "the flagship step",
               "24": "serialization", "25": "the examples"}
# phases 23-25: the flagship step at PN14QP438 (flagship.py; logN, q-limbs, p-limbs), none
# cut; tests/test_ckks.py:90-97's 20 bits; the step's requests and the median of more
FLAGSHIP = (14, 9, 1)
FLAGSHIP_FLOOR = 20
FLAGSHIP_REQUESTS, FLAGSHIP_REPEATS = 3, 10
# tests/test_serialization.py:105's plaintext: its parameters and its digest
WIRE_LITERAL = dict(logn=6, logq=(45, 45), logp=(45,), log_default_scale=40)
WIRE_PT_SHA256 = "c41d1ceaadc10de792cab7744df18b2415947e379c058c3f0a8f3f1374af7b81"
EXAMPLE_LOGNS = (5, 6, 7, 8)  # the examples' rings (B4's CI mode at 2^6)
# Phase 26, the multi-device code (parallel/, multiparty/mesh.py) with k ranks on the
# one card: kernel B6 (csrc/ntt_sharded.cu) and the JAX code it replaces; the
# coefficient-sharded NTT on the flagship's moduli, its shard counts and the lead of its
# input; the limb-sharded step at bench.py's (14, 19, 3) shape with L cut to 16 (19 is
# prime: no mesh divides it) and its rank counts; the party axis' literal (8 parties at
# 45-bit primes: 8 * 2^45 stays below the 2^52 psum bound) and its floor
# (tests/test_multiparty_mesh.py:50-63); each sharded call timed as the median of this
# many after one warm call.
B6_SOURCE = "matrix_fhe_tpu_torch/csrc/ntt_sharded.cu"
B6_REPLACES = "matrix_fhe_tpu/parallel/ntt_sharded.py:127"
PAR_NTT_SHARDS = (8, 2, 1)
PAR_NTT_LEAD = 2
PAR_FAST = dict(logn=14, num_q=16, num_p=3, rescale_limbs=2, seed=SEED)
PAR_BATCH = 3
PAR_PK_LITERAL = dict(logn=14, logq=(45,) * 9, logp=(45,), log_default_scale=40)
PAR_PK_PARTIES = 8
PAR_PK_FLOOR = 10
PAR_REPEATS = 5


class PhaseClock:
    """The wall time of each phase, s: the time between two marks goes to
    the phase the second one names."""

    def __init__(self):
        self.times: dict = {}
        self.last = time.perf_counter()

    def done(self, n: int) -> None:
        now = time.perf_counter()
        self.times[n] = self.times.get(n, 0.0) + now - self.last
        self.last = now


def _digest(tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.cpu().numpy().astype("<i4").tobytes())
    return h.hexdigest()


def _event_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of fn() over ``iters`` launches, by CUDA events."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def _host_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean host time of one call of fn() (the wrapper's enqueue), the
    device left to run behind it."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host = time.perf_counter() - t0
    torch.cuda.synchronize()
    return host * 1e3 / iters


def _hold_device(host_s: float) -> None:
    """Keep the device busy for a while (a spin kernel) so that the launches
    enqueued after it run back to back."""
    torch.cuda._sleep(int(min(max(host_s * 1.5, 1e-3), 0.5) * 2e9))


def _device_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of fn() over ``iters`` launches queued behind a spin
    kernel: the events time the device alone, without the host's gaps
    between the launches of a kernel shorter than its wrapper's host time."""
    host = _host_ms(fn, 1, warmup) / 1e3
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    _hold_device(host * iters)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def _flushed_ms(fn, flush: torch.Tensor, iters: int = 20) -> float:
    """Mean device time of fn() with L2 flushed before each launch: a write
    of ``flush`` (larger than the 50 MB L2) between launches, outside the
    timed spans."""
    fn()
    torch.cuda.synchronize()
    spans = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
             for _ in range(iters)]
    _hold_device(2e-4 * iters)
    for start, stop in spans:
        flush.zero_()
        start.record()
        fn()
        stop.record()
    torch.cuda.synchronize()
    return sum(start.elapsed_time(stop) for start, stop in spans) / iters


def _bound(rows: int, limbs: int, n: int, k: int, int32_ops_per_s: float):
    """(bytes time, operations time) in ms of k transforms of ``rows`` rows
    over ``limbs`` limbs of N = n."""
    nbytes = 4 * n * (2 * rows + 2 * limbs)
    ops = rows * k * (n // 2) * (n.bit_length() - 1) * OPS_PER_BUTTERFLY
    return nbytes / HBM_BYTES_PER_S * 1e3, ops / int32_ops_per_s * 1e3


def _bound_entry(parts) -> dict:
    """bound_ms and bound_by of a kernel over one or more (bytes, ops) times."""
    total = sum(max(b, o) for b, o in parts)
    by = "operations" if sum(o for _, o in parts) >= sum(b for b, _ in parts) else "bytes"
    return {"bound_ms": total, "bound_by": by}


def _operands(rng, shape, moduli) -> torch.Tensor:
    hi = np.array(moduli, dtype=np.int64)[:, None]
    return torch.from_numpy((rng.integers(0, 1 << 62, shape) % hi).astype(np.int32))


def _session_vectors(slots: int):
    """tools/port_precision_floor.py:vectors: the same draws."""
    rng = np.random.default_rng(SEED)
    return [rng.uniform(-1, 1, slots) + 1j * rng.uniform(-1, 1, slots) for _ in range(2)]


def _gen(site: int) -> torch.Generator:
    """The CPU generator of one draw site (a key, a ciphertext): the card's
    session and the CPU reference draw the same arrays."""
    return torch.Generator().manual_seed(1000 * SEED + site)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize()


def _timed(times: dict, name: str, device, fn):
    _sync(device)
    t0 = time.perf_counter()
    out = fn()
    _sync(device)
    times[name] = (time.perf_counter() - t0) * 1e3
    return out


def session_params(device, logn=LOGN, num_q=NUM_Q, num_p=NUM_P):
    from matrix_fhe_tpu_torch.fast import fring
    from matrix_fhe_tpu_torch.schemes import ckks
    moduli = fring.find_fast_primes(1 << logn, num_q + num_p)
    return ckks.new_parameters(ckks.CKKSParametersLiteral(
        logn=logn, q=tuple(moduli[:num_q]), p=tuple(moduli[num_q:]),
        log_default_scale=SESSION_LOG_SCALE), device=device)


def session_keys(params, rotations, times: dict):
    """Secret, relinearization and galois keys through the user's entry
    points, each from its own generator."""
    from matrix_fhe_tpu_torch.rlwe import keys as K
    dev = params.device
    sk = _timed(times, "keygen secret", dev, lambda: K.gen_secret_key(_gen(1), params))
    rlk = _timed(times, "keygen relinearization", dev,
                 lambda: K.gen_relinearization_key(_gen(2), params, sk))
    gks = _timed(times, f"keygen galois x{len(rotations)}", dev, lambda: {
        params.galois_element(k): K.gen_galois_key(_gen(10 + k), params, sk,
                                                   params.galois_element(k))
        for k in rotations})
    return sk, rlk, gks


def session_run(params, sk, rlk, gks, rotations, times: dict) -> dict:
    """Encode and encrypt two vectors, multiply and rescale twice on the
    fast path, rotate the first over ``rotations``, decrypt and decode."""
    from matrix_fhe_tpu_torch.fast import feval
    from matrix_fhe_tpu_torch.ops import ntt_cuda
    from matrix_fhe_tpu_torch.rlwe import decryptor, encryptor
    from matrix_fhe_tpu_torch.schemes import ckks
    dev = params.device
    enc = feval.FastEncoder(params)
    v1, v2 = _session_vectors(params.max_slots)

    def encrypt(v, site):
        return feval.ct_to_fast(encryptor.encrypt(_gen(site), params, sk, enc.encode(v)))

    ca = _timed(times, "encode + encrypt", dev, lambda: encrypt(v1, 51))
    cb = encrypt(v2, 52)
    fast = feval.make_fast_evaluator(params, rlk, gks)
    counts = {}
    for what, fn in (("multiply", lambda: fast.rescale(fast.rescale(fast.mul_relin(ca, cb)))),
                     ("rotations", lambda: fast.rotate_hoisted(ca, list(rotations)))):
        _sync(dev)
        ntt_cuda.fwd_launches = ntt_cuda.bwd_launches = 0
        out = _timed(times, what, dev, fn)
        counts[what] = {"fwd": ntt_cuda.fwd_launches, "bwd": ntt_cuda.bwd_launches}
        if what == "multiply":
            prod = out
        else:
            rots = out

    def decode(ct):
        return enc.decode(decryptor.decrypt(params, sk, feval.ct_to_u64(ct)))

    dec_prod = _timed(times, "decrypt + decode", dev, lambda: decode(prod))
    dec_rots = {k: decode(rots[k]) for k in rotations}
    prec = {"product": ckks.precision_stats(v1 * v2, dec_prod).min_precision,
            "rotations": min(ckks.precision_stats(np.roll(v1, -k), dec_rots[k]).min_precision
                             for k in rotations)}
    return {"cts": (ca, cb), "prod": prod, "rots": rots, "dec_prod": dec_prod,
            "dec_rots": dec_rots, "precision": prec, "counts": counts}


def _same(a, b) -> bool:
    """Equal tensors (b moved to a's device), field by field through keys
    and ciphertexts."""
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b.to(a.device))
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if hasattr(a, "__dataclass_fields__"):
        return all(_same(getattr(a, f), getattr(b, f)) for f in a.__dataclass_fields__)
    if isinstance(a, np.ndarray):
        return np.array_equal(a, b)
    return a == b


def _tree_digest(obj) -> str:
    """sha256 of ``obj``'s tensors, arrays and values, walked as ``_same``
    walks them: two trees with equal digests are equal under ``_same``."""
    h = hashlib.sha256()

    def walk(o):
        if isinstance(o, torch.Tensor):
            h.update(f"tensor {o.dtype} {tuple(o.shape)}".encode())
            h.update(o.detach().cpu().contiguous().numpy().tobytes())
        elif isinstance(o, dict):
            h.update(f"dict {len(o)}".encode())
            for k, v in o.items():
                h.update(repr(k).encode())
                walk(v)
        elif isinstance(o, (tuple, list)):
            h.update(f"list {len(o)}".encode())
            for v in o:
                walk(v)
        elif hasattr(o, "__dataclass_fields__"):
            for f in o.__dataclass_fields__:
                h.update(f.encode())
                walk(getattr(o, f))
        elif isinstance(o, np.ndarray):
            h.update(f"array {o.dtype} {o.shape}".encode())
            h.update(np.ascontiguousarray(o).tobytes())
        else:
            h.update(repr(o).encode())
    walk(obj)
    return h.hexdigest()


def _to_cpu(gk):
    import dataclasses
    g = gk.gadget
    return dataclasses.replace(gk, gadget=dataclasses.replace(
        g, q=g.q.cpu(), p=None if g.p is None else g.p.cpu()))


def int32_rate(sms: int) -> tuple:
    """The card's maximum SM clock (MHz, nvidia-smi) and its int32 rate, op/s."""
    max_sm_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60).stdout.split()[0])
    return max_sm_mhz, INT32_OPS_PER_CLOCK_PER_SM * sms * max_sm_mhz * 1e6


def card_label() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]


def check_int64_wrap(dev) -> None:
    """The u64 path holds 64-bit words in int64 and needs * + - to wrap mod
    2^64 and >> to be arithmetic on the card as on the CPU."""
    from matrix_fhe_tpu_torch.ops import modmath as mm
    rng = np.random.default_rng(SEED)
    a = rng.integers(np.iinfo(np.int64).min, np.iinfo(np.int64).max, 1 << 16, dtype=np.int64)
    b = rng.integers(np.iinfo(np.int64).min, np.iinfo(np.int64).max, 1 << 16, dtype=np.int64)
    a[:4] = [(1 << 62) + 12345, -(1 << 63), (1 << 63) - 1, -1]
    b[:4] = [(1 << 62) - 777, -1, (1 << 63) - 1, 1 << 62]
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    ga, gb = ta.to(dev), tb.to(dev)
    ops = {"mul": lambda x, y: x * y, "add": lambda x, y: x + y, "sub": lambda x, y: x - y,
           "shr": lambda x, y: x >> 32, "neg": lambda x, y: -x,
           "mul64_hi": mm.mul64_hi, "ult": lambda x, y: mm.add64_carry(x, y)[1]}
    for name, op in ops.items():
        cpu, card = op(ta, tb), op(ga, gb).cpu()
        assert torch.equal(cpu, card), f"int64 {name}: the card differs from the CPU"
    # and both are the exact words, against Python's integers
    want = [mm.signed(int(x) * int(y)) for x, y in zip(a[:64], b[:64])]
    assert (ops["mul"](ga, gb)[:64].cpu().tolist()) == want, "int64 * does not wrap mod 2^64"
    hi = [(mm.unsigned(int(x)) * mm.unsigned(int(y))) >> 64 for x, y in zip(a[:64], b[:64])]
    assert [mm.unsigned(v) for v in mm.mul64_hi(ga, gb)[:64].cpu().tolist()] == hi


# -- phase 9: bootstrapping at logN = 14 ----------------------------------------

def _move(obj, device):
    """``obj`` (tensors in dataclasses, dicts, lists and tuples) on ``device``."""
    import dataclasses
    if isinstance(obj, torch.Tensor):
        return obj.to(device)
    if isinstance(obj, dict):
        return {k: _move(v, device) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_move(v, device) for v in obj)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{f.name: _move(getattr(obj, f.name), device)
                                           for f in dataclasses.fields(obj) if f.init})
    return obj


def boot_decode(bts, sk, ct) -> np.ndarray:
    """Decrypt a fast-path ciphertext of the bootstrapper's parameters and
    decode its slots."""
    from matrix_fhe_tpu_torch.fast import feval
    from matrix_fhe_tpu_torch.rlwe import decryptor
    return bts.enc.decode(decryptor.decrypt(bts.p.params, sk, feval.ct_to_u64(ct)))


def boot_keys(p, times: dict):
    """The secret key, then every evaluation key of the bootstrap (the
    relinearization key, the galois keys, the sparse secret and the two
    encapsulation keys): ``gen_evaluation_keys`` in its two parts, the draws
    on a CPU generator and the deterministic part, timed apart."""
    from matrix_fhe_tpu_torch.circuits.ckks import bootstrapping as btp
    from matrix_fhe_tpu_torch.rlwe import keys as K
    dev = p.params.device
    sk = _timed(times, "keygen secret", dev, lambda: K.gen_secret_key(_gen(101), p.params))
    samples = _timed(times, f"keygen draws ({len(p.galois_elements())} galois + 3)", dev,
                     lambda: btp.sample_evaluation_keys(_gen(102), p))
    evk = _timed(times, "keygen deterministic part", dev,
                 lambda: btp.evaluation_keys_from_samples(p, sk, samples))
    return sk, evk


def _launched(wrapper, fn, entries=("ntt_fwd", "ntt_bwd"),
              counters=("fwd_launches", "bwd_launches")):
    """fn() and the launches of ``wrapper``'s kernel in it, by direction:
    those its entry points ``entries`` made (their ``counters``, read just
    before and just after) and those the CUDA graphs replayed under their
    names (utils/graphs.py replays: a capture counts none, a replay every
    launch the capture recorded)."""
    from matrix_fhe_tpu_torch.utils import graphs
    before = [getattr(wrapper, c) for c in counters]
    with graphs.replays() as rep:
        out = fn()
    return out, {d: getattr(wrapper, c) - b + rep.count(f"{wrapper.__name__}.{e}")
                 for d, c, e, b in zip(("fwd", "bwd"), counters, entries, before)}


def _counted(dev, fn):
    """fn() and B1's launches in it (counts zeroed just before, read just
    after; the graphs' replays with them)."""
    from matrix_fhe_tpu_torch.ops import ntt_cuda
    _sync(dev)
    ntt_cuda.fwd_launches = ntt_cuda.bwd_launches = 0
    return _launched(ntt_cuda, fn)


def boot_session(p, sk, evk, times: dict, repeats: int = 0) -> dict:
    """Build the bootstrapper, encrypt the input at the residual level,
    bootstrap it (``repeats`` more times after, timed apart), run META-BTS
    with two iterations, decrypt and decode both."""
    from matrix_fhe_tpu_torch.fast import fboot, feval
    from matrix_fhe_tpu_torch.rlwe import encryptor
    from tools.port_precision_floor import boot_vector
    params = p.params
    dev = params.device
    bts = _timed(times, "make_fast_bootstrapper", dev, lambda: fboot.make_fast_bootstrapper(p, evk))
    v = boot_vector(params.max_slots)
    ct = _timed(times, "encode + encrypt", dev, lambda: feval.ct_to_fast(encryptor.encrypt(
        _gen(103), params, sk, bts.enc.encode(v, level=p.residual_level))))
    out, counts = _counted(dev, lambda: _timed(times, "bootstrap", dev, lambda: bts.bootstrap(ct)))
    reps = []
    for _ in range(repeats):
        _timed(times, "bootstrap again", dev, lambda: bts.bootstrap(ct))
        reps.append(times["bootstrap again"])
    meta, meta_counts = _counted(dev, lambda: _timed(
        times, "evaluate(iterations=2)", dev, lambda: bts.evaluate(ct, iterations=2)))

    dec = _timed(times, "decrypt + decode", dev, lambda: boot_decode(bts, sk, out))
    return {"bts": bts, "v": v, "ct": ct, "boot": out, "meta": meta, "dec": dec,
            "dec_meta": boot_decode(bts, sk, meta), "counts": {"bootstrap": counts, "evaluate": meta_counts},
            "repeats": reps}


def _plain_coeffs(params, sk, ct) -> list[int]:
    """The centered integer coefficients of ct's decryption."""
    from matrix_fhe_tpu_torch.fast import feval
    from matrix_fhe_tpu_torch.rlwe import decryptor
    from matrix_fhe_tpu_torch.schemes.ckks.encoder import crt_reconstruct_centered
    pt = decryptor.decrypt(params, sk, feval.ct_to_u64(ct))
    limbs = params.ring_q.at_level(pt.level).intt(pt.value).cpu().numpy()
    return crt_reconstruct_centered(limbs, params.q[: pt.level + 1])


def _centered_mod(c: int, m: int) -> int:
    r = c % m
    return r - m if r > m // 2 else r


def boot_stages(bts, sk, ct, v):
    """Decrypt and decode after each stage of the bootstrap (ScaleDown,
    ModUp, CoeffsToSlots, EvalMod, SlotsToCoeffs), as ``bootstrap`` runs
    them.  Each stage's result is held against two references:
      * ``own``: what the stage computes, exactly, on the values its input
        decrypts to (ModUp: the input's plaintext plus multiples of q0
        times the ModUp scale factor; CoeffsToSlots: the input's plaintext
        coefficients, bit-reversed, times the matrix scaling over the
        scale; EvalMod: the real part of its input with those multiples
        removed, so the imaginary part CoeffsToSlots leaves counts as
        EvalMod's error too; SlotsToCoeffs: the special FFT of its input's
        slots, re + i im, times its scaling);
      * ``total``: what the bootstrap should hold at that point (from the
        values v and from ScaleDown's plaintext).
    Returns (rows of (stage, level, log2 scale, own stats, total stats,
    a note), the final ciphertext)."""
    from fractions import Fraction

    from matrix_fhe_tpu_torch.schemes import ckks
    from matrix_fhe_tpu_torch.schemes.ckks.encoder import _bit_reverse_perm
    params = bts.p.params
    enc = getattr(bts.enc, "_u64", bts.enc)  # the u64 encoder under a FastEncoder
    half = params.max_slots
    br = _bit_reverse_perm(half)
    c2s_sc = bts.c2s_matrix.literal.scaling
    s2c_sc = bts.s2c_matrix.literal.scaling

    def decode(c):
        return boot_decode(bts, sk, c)

    def slots_of(coeffs, scale):
        """Decode of integer coefficients at ``scale``."""
        f = np.array([float(Fraction(c) / scale) for c in coeffs])
        return enc.special_fft(f[:half] + 1j * f[half:])

    def stats(want, got):
        s = ckks.precision_stats(want, got)
        return s.avg_precision, s.min_precision

    def rms_bits(x):
        return float(np.log2(np.sqrt(np.mean(np.abs(x) ** 2)) + 1e-300))

    rows = []
    ct0 = bts.scale_down(ct)
    got0 = decode(ct0)
    rows.append(("ScaleDown", ct0, stats(v, got0), stats(v, got0), ""))
    c0 = _plain_coeffs(params, sk, ct0)
    msg = np.array([float(Fraction(c) / ct0.scale) for c in c0])  # the message's coefficients
    if bts.evk_dense_to_sparse is not None:  # now under the sparse secret, until ModUp
        ct0 = bts.ev.apply_evaluation_key(ct0, bts.evk_dense_to_sparse)

    ct1 = bts.mod_up(ct0)
    factor = ct1.scale / ct0.scale
    assert factor.denominator == 1, factor
    m = int(factor) * params.q[0]
    c1 = _plain_coeffs(params, sk, ct1)
    r1 = [_centered_mod(c, m) for c in c1]
    overflow = max(abs((c - r) // m) for c, r in zip(c1, r1))
    got1 = slots_of(r1, ct1.scale)
    rows.append(("ModUp", ct1, stats(got0, got1), stats(v, got1),
                 f"plaintext = message + {m} I, max |I| = {overflow}"))

    re, im = bts.coeffs_to_slots(ct1)
    g_re, g_im = decode(re), decode(im)
    full = np.array([float(Fraction(c) / ct1.scale) for c in c1]) * c2s_sc
    want_re, want_im = full[:half][br], full[half:][br]
    got_c2s = np.concatenate([g_re, g_im])
    own = stats(np.concatenate([want_re, want_im]), got_c2s)
    msg_c2s = np.concatenate([msg[:half][br], msg[half:][br]]) * c2s_sc
    err = got_c2s - np.concatenate([want_re, want_im])
    rows.append(("CoeffsToSlots", re, own, own,
                 f"message rms 2^{rms_bits(msg_c2s):.2f}, error rms 2^{rms_bits(err):.2f} "
                 f"(slots of both parts)"))

    e_re, e_im = bts.eval_mod(re), bts.eval_mod(im)
    g2 = np.concatenate([decode(e_re), decode(e_im)])
    # EvalMod of CoeffsToSlots' actual output: the multiples of q0 removed
    x = np.real(got_c2s) / c2s_sc * float(ct1.scale)
    ideal = np.array([float(_centered_mod(int(round(t)), m)) for t in x]) / float(ct1.scale)
    total = np.concatenate([msg[:half][br], msg[half:][br]]) / s2c_sc
    rows.append(("EvalMod", e_re, stats(ideal / s2c_sc, g2), stats(total, g2), ""))

    out = bts.slots_to_coeffs(e_re, e_im)
    got = decode(out)
    ideal_s2c = s2c_sc * enc.special_fft((g2[:half] + 1j * g2[half:])[br])
    rows.append(("SlotsToCoeffs", out, stats(ideal_s2c, got), stats(v, got), ""))
    return rows, out


def boot_circuits(bts, sk) -> dict:
    """The two circuits of the bootstrap held to the JAX package's precision
    (tools/port_precision_floor.py bootstrap): the DFT round trip at each
    input scale and EvalMod, on the bootstrap's keys."""
    from matrix_fhe_tpu_torch.fast import feval
    from matrix_fhe_tpu_torch.rlwe import encryptor
    from matrix_fhe_tpu_torch.schemes import ckks
    from tools.port_precision_floor import (DFT_LOG_SCALES, boot_vector, mod1_input,
                                            mod1_prepare)
    params = bts.p.params

    def decode(c):
        return boot_decode(bts, sk, c)

    def encrypt(values, level, scale, site):
        return feval.ct_to_fast(encryptor.encrypt(
            _gen(site), params, sk, bts.enc.encode(values, level=level, scale=scale)))

    out = {}
    v = boot_vector(params.max_slots)
    scaling = bts.c2s_matrix.literal.scaling * bts.s2c_matrix.literal.scaling
    for log_scale in DFT_LOG_SCALES:
        ct = encrypt(v, params.max_level, 1 << log_scale, 104)
        res = bts.slots_to_coeffs(*bts.coeffs_to_slots(ct))
        out[f"dft round trip 2^{log_scale}"] = ckks.precision_stats(v, decode(res) / scaling)
    m1p = bts.mod1_params
    values, want = mod1_input(m1p, params.max_slots)
    ct = mod1_prepare(bts.ev, encrypt(values, bts.p.mod1_lit.level_q + 1, None, 105), m1p,
                      params.q[0])
    out["eval_mod"] = ckks.precision_stats(want, np.real(decode(bts.mod1_eval.evaluate(ct))))
    return out


def ntt_shapes(fn):
    """fn() with every B1 call recorded: {(direction, shape, tables' address):
    tables}, one entry for each shape and set of moduli."""
    from matrix_fhe_tpu_torch.ops import ntt_cuda
    seen = {}
    fwd, bwd = ntt_cuda.ntt_fwd, ntt_cuda.ntt_bwd

    def recording(direction, kernel):
        def call(x, tabs):
            seen.setdefault((direction, tuple(x.shape), tabs.moduli.data_ptr()), tabs)
            return kernel(x, tabs)
        return call

    ntt_cuda.ntt_fwd, ntt_cuda.ntt_bwd = recording("fwd", fwd), recording("bwd", bwd)
    try:
        fn()
    finally:
        ntt_cuda.ntt_fwd, ntt_cuda.ntt_bwd = fwd, bwd
    return seen


def check_ntt_shapes(shapes: dict, dev, rng) -> list:
    """B1 against its plain version at each recorded shape (the moduli of
    its call, random residues), and its time there: one row a shape."""
    from matrix_fhe_tpu_torch.ops import ntt_cuda, ntt_plain
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rows = []
    for (d, shape, _), tabs in sorted(shapes.items(), key=lambda kv: (kv[0][1][-2], kv[0])):
        mods = tabs.moduli.tolist()
        x_cpu = _operands(rng, shape, mods)
        kern = ntt_cuda.ntt_fwd if d == "fwd" else ntt_cuda.ntt_bwd
        plain = ntt_plain.ntt_fwd_plain if d == "fwd" else ntt_plain.ntt_bwd_plain
        got = kern(x_cpu.to(dev), tabs)
        want = plain(x_cpu, ntt_cuda.build_tables(shape[-1], mods, "cpu"))
        err = int((got.cpu().long() - want.long()).abs().max())
        rows_n = int(np.prod(shape[:-1]))
        rows.append((d, shape, ntt_cuda.geometry(rows_n, shape[-1], 1, sms), err,
                     _device_ms(lambda: kern(got, tabs))))
    return rows


# -- phase 27: the staged bootstrap, one CUDA graph a stage ----------------------------------

def staged_input(bts, sk, site: int):
    """A second input of the bootstrap, of the first one's level and scale:
    another vector, encrypted in the same session (draw site ``site``); as
    int32 limbs for the fast bootstrapper, u64 words for the wide one."""
    from matrix_fhe_tpu_torch.fast import feval
    from matrix_fhe_tpu_torch.rlwe import encryptor
    p = bts.p
    v = np.random.default_rng(site).uniform(-1, 1, p.params.max_slots)
    ct = encryptor.encrypt(_gen(site), p.params, sk, bts.enc.encode(v, level=p.residual_level))
    return feval.ct_to_fast(ct) if isinstance(bts.enc, feval.FastEncoder) else ct


def graph_counts(st) -> dict:
    """The nodes of a StagedBootstrapper's graphs, each graph counted as
    often as one bootstrap replays it: B1's and B4's kernel nodes by
    direction, all kernel nodes, the other nodes (copies, fills), the
    replays and the graphs."""
    from matrix_fhe_tpu_torch.utils import launches
    out = {"B1": {"fwd": 0, "bwd": 0}, "B4": {"fwd": 0, "bwd": 0}, "kernels": 0, "other": 0,
           "replays": len(st.graphs), "graphs": len({id(g) for g in st.graphs})}
    nodes = {}
    for g in st.graphs:
        assert len(g.entries) == 1, f"stage {g.name}: {len(g.entries)} signatures"
        if id(g) not in nodes:
            nodes[id(g)] = launches.graph_nodes(next(iter(g.entries.values())).graph)
        for name in nodes[id(g)]:
            if name.startswith("node type"):
                out["other"] += 1
                continue
            out["kernels"] += 1
            for d in ("fwd", "bwd"):
                out["B1"][d] += f"ntt_{d}_kernel" in name
                out["B4"][d] += f"ntt64_{d}_kernel" in name
    return out


def _pool_bytes(pool, held: bool = False) -> int:
    """The bytes the caching allocator holds in the graphs' memory pool
    ``pool`` (its segments), or with ``held`` those of its blocks in use
    (the graphs' outputs and whatever else a graph keeps)."""
    segs = [seg for seg in torch.cuda.memory_snapshot()
            if tuple(seg.get("segment_pool_id", ())) == tuple(pool)]
    return sum(seg["allocated_size" if held else "total_size"] for seg in segs)


def staged_phase(path: str, s: dict, rows, sk, site: int, dev, smi: str, ct2=None,
                 stagewise: bool = True) -> dict:
    """Phase 27 on one path: ``s`` holds phase 9's (or 12's) bootstrapper
    ``bts``, its input ``ct``, its eager output ``boot``, the eager
    bootstrap's launches ``counts`` and its warm ``repeats``; ``rows`` are
    boot_stages' of ``ct``.  The staged bootstrapper's first call (eager
    warm-up, capture, replay, timed apart), the two inputs (the second
    ``ct2``, or one ``staged_input`` makes) held to the eager bootstrap bit
    for bit, each stage held to the eager stage (``stagewise``), the graphs'
    kernel nodes held to the eager launches, the replays' times, the peak
    memory and the graphs' pool.  Returns the staged outputs of both inputs
    with the numbers.  On the CPU (a dry run: stub the torch.cuda memory
    calls, _device_ms, graph_counts and _pool_bytes) the stages run eagerly."""
    from matrix_fhe_tpu_torch.circuits.ckks import staged
    from matrix_fhe_tpu_torch.ops import ntt64_cuda, ntt_cuda
    bts, ct = s["bts"], s["ct"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    st = staged.StagedBootstrapper(bts)
    t0 = time.perf_counter()
    (first, b1_first), b4_first = _b4_counted(dev, lambda: _counted(dev, lambda: st(ct)))
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    pool = _pool_bytes(st.graphs[0].pool) if dev.type == "cuda" else 0
    seconds = [e.seconds for g in {id(g): g for g in st.graphs}.values()
               for e in g.entries.values()]
    warm_s = sum(x["warm-up"] for x in seconds)
    capture_s = sum(x["capture"] for x in seconds)
    assert _same(first, s["boot"]), f"{path}: staged bootstrap != bootstrap"

    # a second input through the same graphs, against the eager bootstrap
    if ct2 is None:
        ct2 = staged_input(bts, sk, site)
    (eager2, b1_eager), b4_eager = _b4_counted(dev, lambda: _counted(
        dev, lambda: bts.bootstrap(ct2)))
    (out2, b1_replay), b4_replay = _b4_counted(dev, lambda: _counted(dev, lambda: st(ct2)))
    wrappers = {"B1": {"fwd": ntt_cuda.fwd_launches, "bwd": ntt_cuda.bwd_launches},
                "B4": {"fwd": ntt64_cuda.fwd_launches, "bwd": ntt64_cuda.bwd_launches}}
    assert _same(out2, eager2), f"{path}: staged bootstrap of a second input != bootstrap"
    assert not _same(out2, first)
    eager = {"B1": b1_eager, "B4": b4_eager}
    for k, c in s["counts"].items():  # phase 9's or 12's count of one bootstrap
        assert eager[k] == c, f"{path}: {k} launches {eager[k]} != {c}"
    # no stage runs eagerly: a replayed bootstrap passes through no wrapper,
    # and its graphs replay every launch of the eager bootstrap (on the CPU,
    # a dry run, every stage is eager)
    if dev.type == "cuda":
        zero = {"fwd": 0, "bwd": 0}
        assert wrappers == {"B1": zero, "B4": zero}, wrappers
        assert {"B1": b1_replay, "B4": b4_replay} == eager, (b1_replay, b4_replay)

    # stage by stage: against the eager stages, and ct's against boot_stages'
    for c in (ct, ct2) if stagewise else ():
        got, want = list(st.run_stages(c)), list(st.run_stages(c, eager=True))
        assert [n for n, _ in got] == [n for n, _ in want]
        for (name, a), (_, b) in zip(got, want):
            assert _same(a, b), f"{path}: stage {name} != the eager stage"
    if stagewise:
        by_stage = dict(st.run_stages(ct))
        by_row = {r[0]: r[1] for r in rows}
        for stage, row in (("head", "ModUp"), ("c2s_tail", "CoeffsToSlots"),
                           (list(by_stage)[-1], "SlotsToCoeffs")):
            assert _same(by_stage[stage], by_row[row]), f"{path}: stage {stage} != {row}"

    nodes = graph_counts(st)
    for k in ("B1", "B4"):
        assert nodes[k] == eager[k], f"{path}: {k} nodes {nodes[k]} != launches {eager[k]}"
    assert sum(nodes["B1"].values()) + sum(nodes["B4"].values()) > 0

    reps = []
    for _ in range(STAGED_REPEATS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st(ct2)
        torch.cuda.synchronize()
        reps.append((time.perf_counter() - t0) * 1e3)
    device = _device_ms(lambda: st(ct2), iters=STAGED_REPEATS, warmup=1)
    peak = torch.cuda.max_memory_allocated() - held
    eager_ms = statistics.median(s["repeats"])
    names = [n for n, _ in st.run_stages(ct2)]
    print(f"phase staged: {path}: {nodes['graphs']} graphs, {nodes['replays']} replays a "
          f"bootstrap, stages {', '.join(names)} | {smi}")
    print(f"phase staged: {path}: first call {first_s * 1e3:.3f} ms: eager warm-up "
          f"{warm_s * 1e3:.3f} ms, capture + instantiate {capture_s * 1e3:.3f} ms, the "
          f"replays and copies {(first_s - warm_s - capture_s) * 1e3:.3f} ms; launches in "
          f"it (the warm-up's and the replays') B1 {b1_first}, B4 {b4_first} | {smi}")
    print(f"phase staged: {path}: bootstrap of two inputs == bts.bootstrap bit for bit"
          f"{', every stage == the eager stage' if stagewise else ''}; B1 kernel nodes "
          f"{nodes['B1']}, B4 kernel nodes "
          f"{nodes['B4']} == the eager bootstrap's launches; {nodes['kernels']} kernel nodes "
          f"and {nodes['other']} other nodes a bootstrap; 0 wrapper launches in a replayed "
          f"bootstrap, whose graphs replay the eager bootstrap's launches | {smi}")
    print(f"phase staged: {path}: staged bootstrap, {STAGED_REPEATS} replays: "
          f"{', '.join(f'{t:.3f}' for t in reps)} ms, median {statistics.median(reps):.3f} ms "
          f"(device time queued {device:.3f} ms a bootstrap); eager warm median "
          f"{eager_ms:.3f} ms ({len(s['repeats'])} repeats) | {smi}")
    print(f"phase staged: {path}: peak device memory {peak / 2**20:.1f} MiB above the "
          f"{held / 2**20:.1f} MiB the earlier phases hold; the graphs' pool "
          f"{pool / 2**20:.1f} MiB | {smi}")
    del st
    return {"nodes": nodes, "median_ms": statistics.median(reps), "eager_ms": eager_ms,
            "device_ms": device, "reps": reps, "first_s": first_s, "warm_s": warm_s,
            "capture_s": capture_s, "peak": peak, "pool": pool, "outs": (first, out2),
            "eager2": eager2}


# -- phase 28: the reference's production bootstrap at logN 16 ---------------------------

def dft_matrices_digest(*matrices) -> str:
    """sha256 of DFT matrices (``dft.Matrix`` of either package, in order):
    each factor's scale, levels and baby-step count, then each diagonal's
    index and its Q and P words as little-endian 64-bit words."""
    h = hashlib.sha256()
    for m in matrices:
        for lt in m.matrices:
            h.update(f"{lt.scale} {lt.level_q} {lt.level_p} {lt.n1}".encode())
            for k in sorted(lt.vec):
                h.update(str(k).encode())
                for w in lt.vec[k]:
                    if w is not None:
                        a = w.cpu().numpy() if isinstance(w, torch.Tensor) else np.asarray(w)
                        h.update(a.astype("<i8").tobytes())
    return h.hexdigest()


def n16_inputs(slots: int) -> list:
    """Phase 28's two inputs: complex slots from default_rng(SEED)."""
    rng = np.random.default_rng(SEED)
    return [rng.uniform(-1, 1, slots) + 1j * rng.uniform(-1, 1, slots) for _ in range(2)]


def n16_phase(dev, smi: str, rng, int32_ops_per_s: float, clock: PhaseClock) -> dict:
    """Phase 28 (see the module's docstring): the wide bootstrap at
    ``wide61_parameters_literal(*N16_LITERAL)``, eager and staged, held to
    the u64 bootstrap, to itself staged, to the JAX package's criterion and
    matrices; B4 at every shape it gave it.  No CPU reference: the plain
    path cannot bootstrap at 2^16 within the script's limit.  Returns B4's
    launches by path and its loss rows."""
    from matrix_fhe_tpu_torch.circuits.ckks import bootstrapping as btp
    from matrix_fhe_tpu_torch.fast import fboot
    from matrix_fhe_tpu_torch.rlwe import encryptor
    from matrix_fhe_tpu_torch.schemes import ckks
    from matrix_fhe_tpu_torch.utils import graphs
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    times: dict = {}
    seen: dict = {}       # B4's calls by (direction, shape, moduli), the eager parts
    launches: dict = {}   # and its launches there
    p = _timed(times, "btp.Parameters", dev, lambda: btp.Parameters(
        fboot.wide61_parameters_literal(*N16_LITERAL), device=dev))
    params = p.params
    print(f"phase n16: wide61_parameters_literal{N16_LITERAL}: logN {params.log_n}, "
          f"{len(params.q)} + {len(params.p)} primes, Q "
          f"{[q.bit_length() for q in params.q]} bits, P {[q.bit_length() for q in params.p]} "
          f"bits, {params.max_slots} slots, residual level {p.residual_level}, "
          f"{len(p.galois_elements())} galois keys, sparse secret weight "
          f"{p.lit.ephemeral_secret_weight}")
    (sk, evk), b4_keys = _b4_counted(dev, lambda: b4_shapes(lambda: boot_keys(p, times), seen,
                                                            launches))
    bts, b4_setup = _b4_counted(dev, lambda: b4_shapes(lambda: _timed(
        times, "make_wide_bootstrapper", dev, lambda: fboot.make_wide_bootstrapper(p, evk)),
        seen, launches))
    # (e) the DFT matrices are the JAX package's
    mdigest = _timed(times, "digest of the DFT matrices", dev,
                     lambda: dft_matrices_digest(bts.c2s_matrix, bts.s2c_matrix))
    assert mdigest == N16_MATRICES_SHA256, "phase 28: the DFT matrices != the JAX package's"
    diags = sum(len(lt.vec) for m in (bts.c2s_matrix, bts.s2c_matrix) for lt in m.matrices)
    vs = n16_inputs(params.max_slots)
    cts = [_timed(times, f"encode + encrypt ({i})", dev, lambda: encryptor.encrypt(
        _gen(281 + i), params, sk, bts.enc.encode(v, level=p.residual_level)))
        for i, v in enumerate(vs)]
    setup_peak = torch.cuda.max_memory_allocated() - held

    # eager: cold, warm and N16_REPEATS more
    out, b4_boot = _b4_counted(dev, lambda: b4_shapes(lambda: _timed(
        times, "bootstrap (cold)", dev, lambda: bts.bootstrap(cts[0])), seen, launches))
    warm, b4_warm = _b4_counted(dev, lambda: _timed(times, "bootstrap (warm)", dev,
                                                    lambda: bts.bootstrap(cts[0])))
    assert _same(warm, out) and b4_warm == b4_boot, "phase 28: warm bootstrap != cold"
    reps = []
    for _ in range(N16_REPEATS):
        _timed(times, "bootstrap again", dev, lambda: bts.bootstrap(cts[0]))
        reps.append(times.pop("bootstrap again"))
    assert out.level == p.residual_level and out.scale == params.default_scale
    eager_peak = torch.cuda.max_memory_allocated() - held
    dec = _timed(times, "decrypt + decode", dev, lambda: boot_decode(bts, sk, out))
    rows, composed = boot_stages(bts, sk, cts[0], vs[0])
    assert _same(composed, out), "phase 28: the stages composed != bootstrap"
    for name, ms in times.items():
        print(f"phase n16: {name:34s} {ms:10.3f} ms | {smi}")
    print(f"phase n16: eager bootstrap, {N16_REPEATS} more: "
          f"{', '.join(f'{t:.3f}' for t in reps)} ms, median {statistics.median(reps):.3f} ms; "
          f"B4 launches a bootstrap {b4_boot}, keygen {b4_keys}, make_wide_bootstrapper "
          f"{b4_setup} | {smi}")
    print(f"phase n16: the {diags} diagonals of the CoeffsToSlots and SlotsToCoeffs matrices "
          f"hash to the JAX package's ({mdigest[:16]}...)")
    for stage, ct_s, own, total, note in rows:
        print(f"phase n16: stage {stage:13s} level {ct_s.level:2d} scale 2^"
              f"{np.log2(float(ct_s.scale)):6.2f} | own mean {own[0]:8.4f} min {own[1]:8.4f} "
              f"bits | total mean {total[0]:8.4f} min {total[1]:8.4f} bits | {note}")
    clock.done(28)

    # staged, on the same bootstrapper: (b) == eager on both inputs, (f) no
    # wrapper launch in a replay
    st = staged_phase(f"n16 wide61_parameters_literal{N16_LITERAL}", {
        "bts": bts, "ct": cts[0], "boot": out, "repeats": reps,
        "counts": {"B4": b4_boot, "B1": {"fwd": 0, "bwd": 0}}}, None, sk, 0, dev, smi,
        ct2=cts[1], stagewise=False)
    clock.done(28)

    # (c) the JAX package's criterion on the decoded eager and staged outputs
    decoded = {"eager, input 0": dec, "eager, input 1": boot_decode(bts, sk, st["eager2"]),
               **{f"staged, input {i}": boot_decode(bts, sk, o) for i, o in enumerate(st["outs"])}}
    missed = []
    for what, d in decoded.items():
        ps = ckks.precision_stats(vs[int(what[-1])], d)
        met = (ps.avg_precision >= WIDE_BOOT_FLOOR["mean"]
               and ps.min_precision >= WIDE_BOOT_FLOOR["min"])
        print(f"phase n16: decoded precision, {what}: mean {ps.avg_precision:.4f} bits, min "
              f"{ps.min_precision:.4f} bits over {len(d)} slots (the JAX package's criterion: "
              f"mean >= {WIDE_BOOT_FLOOR['mean']}, min >= {WIDE_BOOT_FLOOR['min']}: "
              f"{'met' if met else 'MISSED'}) | {smi}")
        if not met:
            missed.append(what)
    assert not missed, f"phase 28: decoded precision below the JAX package's criterion: {missed}"

    # (a) the u64 bootstrap on the same keys and input, limb for limb
    u64_times: dict = {}
    u64 = _timed(u64_times, "btp.Evaluator (u64)", dev, lambda: btp.Evaluator(p, evk))
    out_u64 = _timed(u64_times, "u64 bootstrap", dev, lambda: u64.bootstrap(cts[0]))
    assert out_u64.scale == out.scale and out_u64.level == out.level
    assert _same(tuple(out.value), tuple(out_u64.value)), "phase 28: wide bootstrap != u64"
    print(f"phase n16: wide bootstrap == u64 bootstrap (btp.Evaluator) limb for limb on the "
          f"same keys and input; u64: evaluator {u64_times['btp.Evaluator (u64)']:.3f} ms, "
          f"bootstrap {u64_times['u64 bootstrap']:.3f} ms | {smi}")
    ks = [g for _, g in key_switch_graphs()]
    print(f"phase n16: the key-switch graph caches after keygen, the u64 evaluator and its "
          f"bootstrap: {len(ks)} graphs, their static inputs {_static_bytes(ks) / 2**20:.1f} "
          f"MiB (shared by shape: one copy of a gadget for every level), the shared pool "
          f"{_pool_bytes(graphs.SHARED.pool(dev)) / 2**20:.1f} MiB | {smi}")
    del ks
    del u64, out_u64
    peak = torch.cuda.max_memory_allocated() - held
    print(f"phase n16: peak device memory above the {held / 2**20:.1f} MiB the earlier phases "
          f"hold: setup {setup_peak / 2**20:.1f} MiB, eager {eager_peak / 2**20:.1f} MiB, "
          f"the whole phase {peak / 2**20:.1f} MiB; the graphs' pool {st['pool'] / 2**20:.1f} "
          f"MiB | {smi}")
    clock.done(28)

    # (d) B4 at every shape the phase gave it, all at 2^16
    shape_rows = check_b4_shapes(seen, dev, rng)
    assert all(r[1][-1] == params.n for r in shape_rows)
    for d, shape, c, err, _ in shape_rows:
        assert err == 0, f"B4 {d} {shape}: kernel != plain ({err})"
    print(f"phase b4: B4 at the {len(shape_rows)} shapes (direction, shape, moduli) of phase 28, "
          f"all at 2^{params.log_n}: kernel == plain at every one; (rows, C): "
          f"{sorted({(int(np.prod(r[1][:-1])), r[2]) for r in shape_rows})}")
    loss = b4_loss(seen, launches, dev, rng, int32_ops_per_s, smi, "phase 28")
    clock.done(28)
    return {"shape_rows": shape_rows, "loss": loss,
            "by_path": {
                "wide61 N16 bootstrap setup (phase 28: keygen, make_wide_bootstrapper)":
                    {d: b4_keys[d] + b4_setup[d] for d in ("fwd", "bwd")},
                "wide61 N16 bootstrap (phase 28, eager)": b4_boot,
                "staged wide61 N16 bootstrap (phase 28, kernel nodes a bootstrap)":
                    st["nodes"]["B4"]}}



# -- phases 10-13: the wide path (41-61-bit primes) and kernel B4 ------------------

def _counted_in(wrapper, dev, fn):
    """fn() and the launches of ``wrapper``'s kernel (a module with
    ``fwd_launches`` and ``bwd_launches``) in it: counts zeroed just before,
    read just after, the graphs' replays with them."""
    _sync(dev)
    wrapper.fwd_launches = wrapper.bwd_launches = 0
    return _launched(wrapper, fn)


def _b4_counted(dev, fn):
    """fn() and B4's launches in it."""
    from matrix_fhe_tpu_torch.ops import ntt64_cuda
    return _counted_in(ntt64_cuda, dev, fn)


def _shapes_in(wrapper, fn, seen: dict, names=("ntt_fwd", "ntt_bwd"), counts=None):
    """fn() with every call of ``wrapper``'s entry points ``names`` (forward,
    inverse; each takes (x, ring)) recorded into ``seen``:
    {(direction, shape, moduli): ring}, and the kernel's launches counted
    into ``counts`` by the same key: the calls on a CUDA tensor outside a
    capture, and the launches the CUDA graphs replayed under the entry
    points' names (utils/graphs.py replays, whose rings join ``seen``)."""
    from matrix_fhe_tpu_torch.utils import graphs
    fwd, bwd = (getattr(wrapper, name) for name in names)

    def recording(direction, kernel):
        def call(x, ring):
            key = (direction, tuple(x.shape), ring.moduli_tuple)
            seen.setdefault(key, ring)
            if counts is not None and x.is_cuda and not torch.cuda.is_current_stream_capturing():
                counts[key] = counts.get(key, 0) + 1
            return kernel(x, ring)
        return call

    setattr(wrapper, names[0], recording("fwd", fwd))
    setattr(wrapper, names[1], recording("bwd", bwd))
    try:
        with graphs.replays() as rep:
            out = fn()
    finally:
        setattr(wrapper, names[0], fwd)
        setattr(wrapper, names[1], bwd)
    directions = {f"{wrapper.__name__}.{e}": d for d, e in zip(("fwd", "bwd"), names)}
    for name, shape, ring, n in rep.items():
        if name in directions:
            key = (directions[name], shape, ring.moduli_tuple)
            seen.setdefault(key, ring)
            if counts is not None:
                counts[key] = counts.get(key, 0) + n
    return out


def b4_shapes(fn, seen: dict, counts=None):
    """fn() with every B4 call recorded into ``seen`` (and its launches
    counted into ``counts``)."""
    from matrix_fhe_tpu_torch.ops import ntt64_cuda
    return _shapes_in(ntt64_cuda, fn, seen, counts=counts)


def _digest64(tensors) -> str:
    """sha256 of words as little-endian int64 (tools/port_reference_digest.py wide)."""
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.cpu().numpy().astype("<i8").tobytes())
    return h.hexdigest()


def _b4_moduli(n: int) -> list[int]:
    """7 primes each of 45, 55 and 61 bits (the 61-bit ones below 2^61)."""
    from matrix_fhe_tpu_torch.utils import primes as pr
    out = []
    for bits in (45, 55, 61):
        g = pr.NTTFriendlyPrimesGenerator(bits, 2 * n)
        out += g.next_downstream_primes(7) if bits == 61 else g.next_alternating_primes(7)
    return out


def _words(rng, lead, moduli, n) -> torch.Tensor:
    x = np.stack([rng.integers(0, q, lead + (n,), dtype=np.int64) for q in moduli], axis=-2)
    x.reshape(-1, n)[0, :2] = [moduli[0] - 1, 0]
    return torch.from_numpy(x)


def _b4_bound(rows: int, limbs: int, n: int, fwd: bool, int32_ops_per_s, ci: bool = False):
    """(bytes time, operations time) in ms of one B4 transform of ``rows``
    rows over ``limbs`` limbs: 8 B a word in and out, and 8 B a distinct
    constant of a limb other than 1 (its N - 1 twiddles, the inverse's N^-1;
    on the CI ring the fold's F forward and F and (2N)^-1 inverse, whose
    stages end with no scale), as B5's bound counts them (no Shoup quotient:
    that is the kernel's own table layout); a Shoup product a butterfly, and
    one an element for the inverse's N^-1, or on the CI ring for the fold
    (and the inverse's (2N)^-1), in multiply-adds on the FMA pipe."""
    constants = n - 1 + ((1 if fwd else 2) if ci else (0 if fwd else 1))
    nbytes = 8 * n * 2 * rows + 8 * constants * limbs
    products = (n // 2) * (n.bit_length() - 1) + (n * (1 if fwd else 2) if ci else
                                                  (0 if fwd else n))
    return (nbytes / HBM_BYTES_PER_S * 1e3,
            rows * products * MULS_SHOUP / (int32_ops_per_s / 2) * 1e3)


def b4_loss(calls: dict, counts: dict, dev, rng, int32_ops_per_s, smi: str, what: str,
            ci: bool = False) -> list:
    """B4 by launch shape: the calls ``counts`` recorded ({(direction,
    shape, moduli): launches}, rings in ``calls``), merged over moduli; for
    each (direction, shape) the launches, the device time queued a launch
    (``_device_ms``), the bound (``_b4_bound``) and the loss, launches x
    (device - bound).  Prints the table and its sum; returns its rows as
    dicts (the moduli of the first ring seen at the shape)."""
    from matrix_fhe_tpu_torch.ops import ntt64_cuda
    names = CI_ENTRIES if ci else ("ntt_fwd", "ntt_bwd")
    merged: dict = {}
    for (d, shape, moduli), n_calls in counts.items():
        rec = merged.setdefault((d, shape), {"ring": calls[d, shape, moduli], "launches": 0})
        rec["launches"] += n_calls
    rows = []
    for (d, shape), rec in sorted(merged.items(), key=lambda kv: (kv[0][1], kv[0][0])):
        ring = rec["ring"]
        kern = getattr(ntt64_cuda, names[0] if d == "fwd" else names[1])
        x = _words(rng, shape[:-2], ring.moduli_tuple, shape[-1]).to(dev)
        device = _device_ms(lambda: kern(x, ring))
        bound = max(_b4_bound(int(np.prod(shape[:-1])), shape[-2], shape[-1], d == "fwd",
                              int32_ops_per_s, ci=ci))
        rows.append({"dir": d, "shape": list(shape), "ci": ci, "moduli": list(ring.moduli_tuple),
                     "launches": rec["launches"], "device_ms": device, "bound_ms": bound,
                     "loss_ms": rec["launches"] * (device - bound)})
        print(f"phase b4 loss: {what} {d} {str(list(shape)):18s} launches {rec['launches']:5d}, "
              f"device queued {device * 1e3:7.2f} us, bound {bound * 1e3:6.3f} us, loss "
              f"{rows[-1]['loss_ms']:8.4f} ms | {smi}")
    print(f"phase b4 loss: {what}, {len(rows)} shapes, {sum(r['launches'] for r in rows)} "
          f"launches: device queued x launches "
          f"{sum(r['launches'] * r['device_ms'] for r in rows):.4f} ms, bound x launches "
          f"{sum(r['launches'] * r['bound_ms'] for r in rows):.4f} ms, loss "
          f"{sum(r['loss_ms'] for r in rows):.4f} ms summed | {smi}")
    return rows


def check_b4_sizes(dev, rng, sms) -> list:
    """B4 against its plain version at N = 2^6 to 2^16 on 45-, 55- and
    61-bit primes, rows [1, 1], [1, 9] and [2, 21], and at N = 2^14 on the
    wide61 P (its first prime above 2^61), rows [2, 2], at the cluster size
    the rule picks and at every size the kernel is built for: one row a
    size, with the device time (queued) of a transform each way at the
    picked C."""
    from matrix_fhe_tpu_torch.fast import wring
    from matrix_fhe_tpu_torch.ops import ntt64_cuda, rings
    out = []
    cases = [(logn, rings.new_ring(1 << logn, _b4_moduli(1 << logn), device=dev),
              (((1,), 1), ((1,), 9), ((2,), 21)), "") for logn in B4_SIZES]
    cases.append((LOGN, wring.new_wide_ring(1 << LOGN, WIDE61_P, device=dev), (((2,), 2),),
                  "wide61 P, above 2^61"))
    for logn, ring, shapes, what in cases:
        n = 1 << logn
        for lead, limbs in shapes:
            r = ring.limbs(0, limbs)
            x_cpu = _words(rng, lead, r.moduli_tuple, n)
            x = x_cpu.to(dev)
            rows = int(np.prod(lead)) * limbs
            picked = ntt64_cuda.geometry(rows, n, sms)
            cs = ntt64_cuda.clusters(n)
            assert picked in cs
            err = 0
            for fwd in (True, False):
                want = (ntt64_cuda.ntt_fwd_plain if fwd else ntt64_cuda.ntt_bwd_plain)(x, r)
                for c in cs:
                    got = ntt64_cuda.launch(x, r, fwd, c)
                    err = max(err, int((got != want).sum()))
                if limbs == 1 or what:  # and the plain version on the CPU
                    cpu = (wring.new_wide_ring if what else rings.new_ring)(
                        n, list(r.moduli_tuple), device="cpu")
                    want_cpu = (ntt64_cuda.ntt_fwd_plain if fwd else ntt64_cuda.ntt_bwd_plain)(
                        x_cpu, cpu)
                    err = max(err, int((want.cpu() != want_cpu).sum()))
            back = r.intt(r.ntt(x))
            torch.cuda.synchronize()
            assert torch.equal(back, x), f"B4 2^{logn} {lead + (limbs,)}: inverse(forward(x)) != x"
            out.append((logn, lead + (limbs, n), picked, cs, _device_ms(lambda: r.ntt(x)),
                        _device_ms(lambda: r.intt(x)), what, err))
    return out


def check_b4_shapes(shapes: dict, dev, rng) -> list:
    """B4 against its plain version at each recorded shape (its moduli,
    random words), its cluster size and its times there: one row a shape."""
    from matrix_fhe_tpu_torch.ops import ntt64_cuda
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rows = []
    for (d, shape, _), ring in sorted(shapes.items(), key=lambda kv: (kv[0][1], kv[0][0])):
        kern = ntt64_cuda.ntt_fwd if d == "fwd" else ntt64_cuda.ntt_bwd
        plain = ntt64_cuda.ntt_fwd_plain if d == "fwd" else ntt64_cuda.ntt_bwd_plain
        x = _words(rng, shape[:-2], ring.moduli_tuple, shape[-1]).to(dev)
        err = int((kern(x, ring) != plain(x, ring)).sum())
        rows.append((d, shape, ntt64_cuda.geometry(int(np.prod(shape[:-1])), shape[-1], sms),
                     err, ring))
    return rows


def _time_in(wrapper, d, shape, ring, dev, rng, flush, plain_iters: int = 20,
             names=("ntt_fwd", "ntt_bwd")) -> dict:
    """``wrapper``'s entry point of ``names`` in direction ``d`` on random
    words of ``shape``: the kernels-line, queued, L2-flushed and host times,
    and the plain version's (the entry point's name + "_plain") time."""
    name = names[0] if d == "fwd" else names[1]
    kern, plain = getattr(wrapper, name), getattr(wrapper, name + "_plain")
    x = _words(rng, shape[:-2], ring.moduli_tuple, shape[-1]).to(dev)
    return {"ms": _event_ms(lambda: kern(x, ring)), "device": _device_ms(lambda: kern(x, ring)),
            "flushed": _flushed_ms(lambda: kern(x, ring), flush),
            "host": _host_ms(lambda: kern(x, ring)),
            "plain_ms": _event_ms(lambda: plain(x, ring), iters=plain_iters,
                                  warmup=min(3, plain_iters))}


def time_b4(d, shape, ring, dev, rng, flush) -> dict:
    from matrix_fhe_tpu_torch.ops import ntt64_cuda
    return _time_in(ntt64_cuda, d, shape, ring, dev, rng, flush)


def wide_step(name: str, dev):
    """Phase 11 for one of bench.py's wide shapes: three requests (each one
    mul_relin_rescale and one rotations_hoisted over the 8 galois elements),
    B4 launches a request, 10 steady repeats, the digests, and the digest of
    every request's outputs (held to ``wide_step_reference`` on the CPU)."""
    from matrix_fhe_tpu_torch.fast import wckks
    ctx, ops = WIDE_SHAPES[name](wckks, dev)
    outs, lat, counts = [], [], []
    for order in WIDE_ORDERS:
        a = [ops[i] for i in order]
        t0 = time.perf_counter()
        step, c_step = _b4_counted(dev, lambda: wckks.mul_relin_rescale(ctx, *a))
        _sync(dev)
        t1 = time.perf_counter()
        rots, c_rot = _b4_counted(dev, lambda: wckks.rotations_hoisted(ctx, a[0], a[1],
                                                                         ctx.gal_els))
        _sync(dev)
        t2 = time.perf_counter()
        outs.append((step, rots))
        lat.append(((t1 - t0) * 1e3, (t2 - t1) * 1e3))
        counts.append({"mul_relin_rescale": c_step, "rotations_hoisted": c_rot})
    assert all(c == counts[0] for c in counts), f"{name}: B4 launches differ by request {counts}"
    reps = {"mul_relin_rescale": [], "rotations_hoisted": []}
    for _ in range(10):
        t0 = time.perf_counter()
        wckks.mul_relin_rescale(ctx, *ops)
        _sync(dev)
        t1 = time.perf_counter()
        wckks.rotations_hoisted(ctx, ops[0], ops[1], ctx.gal_els)
        _sync(dev)
        reps["mul_relin_rescale"].append((t1 - t0) * 1e3)
        reps["rotations_hoisted"].append((time.perf_counter() - t1) * 1e3)
    (o0, o1), rots = outs[0]
    want_step, want_rots = WIDE_STEP_SHA256[name]
    assert _digest64([o0, o1]) == want_step, f"{name}: mul_relin_rescale digest != JAX's"
    assert _digest64([t for g in ctx.gal_els for t in rots[g]]) == want_rots, \
        f"{name}: rotations_hoisted digest != JAX's"
    return {"ctx": ctx, "lat": lat, "counts": counts[0], "reps": reps,
            "digest": _tree_digest(outs)}


def wide_step_reference(dev, times: dict) -> dict:
    """Phase 11's three requests at each of bench.py's wide shapes on
    ``dev`` (the contexts from their seed): the digests of their outputs."""
    from matrix_fhe_tpu_torch.fast import wckks
    digests = {}
    for name in WIDE_SHAPES:
        def requests():
            ctx, ops = WIDE_SHAPES[name](wckks, dev)
            return [(wckks.mul_relin_rescale(ctx, *(ops[i] for i in order)),
                     wckks.rotations_hoisted(ctx, ops[order[0]], ops[order[1]], ctx.gal_els))
                    for order in WIDE_ORDERS]
        digests[name] = _tree_digest(_timed(times, name, dev, requests))
    return {"outs": digests}


def wide_boot_session(p, sk, evk, times: dict, repeats: int = 0) -> dict:
    """Phase 12: build the wide bootstrapper, encrypt the input at the
    residual level, bootstrap it (``repeats`` more times after, timed apart),
    decrypt and decode."""
    from matrix_fhe_tpu_torch.fast import fboot
    from matrix_fhe_tpu_torch.ops import ntt_cuda
    from matrix_fhe_tpu_torch.rlwe import encryptor
    from tools.port_precision_floor import boot_vector
    params = p.params
    dev = params.device
    bts, setup_b4 = _b4_counted(dev, lambda: _timed(
        times, "make_wide_bootstrapper", dev, lambda: fboot.make_wide_bootstrapper(p, evk)))
    v = boot_vector(params.max_slots)
    ct = _timed(times, "encode + encrypt", dev, lambda: encryptor.encrypt(
        _gen(203), params, sk, bts.enc.encode(v, level=p.residual_level)))
    ntt_cuda.launches = 0
    out, counts = _b4_counted(dev, lambda: _timed(times, "bootstrap", dev,
                                                  lambda: bts.bootstrap(ct)))
    b1 = ntt_cuda.launches
    reps = []
    for _ in range(repeats):
        _timed(times, "bootstrap again", dev, lambda: bts.bootstrap(ct))
        reps.append(times["bootstrap again"])
    dec = _timed(times, "decrypt + decode", dev, lambda: boot_decode(bts, sk, out))
    return {"bts": bts, "v": v, "ct": ct, "boot": out, "dec": dec, "repeats": reps,
            "counts": {"bootstrap": counts, "make_wide_bootstrapper": setup_b4, "B1": b1}}


def circuit_inputs(slots: int) -> dict:
    """tests/test_comparison_inverse.py's inputs at ``slots``: {name: values}."""
    def sign_values(rng):
        v = rng.uniform(1 / 16, 1, slots)
        return v * rng.choice([-1.0, 1.0], slots)

    rng = np.random.default_rng(3)
    a, b = rng.uniform(-0.5, 0.5, slots), rng.uniform(-0.5, 0.5, slots)
    mask = np.abs(a - b) < 1 / 16
    b[mask] = a[mask] + 1 / 8
    return {"sign": sign_values(np.random.default_rng(1)),
            "step": sign_values(np.random.default_rng(2)), "a": a, "b": b,
            "goldschmidt": np.random.default_rng(4).uniform(0.25, 1.75, slots),
            "inverse": np.random.default_rng(5).uniform(0.3, 3.0, slots)}


def wide_circuits(dev, times: dict, keys=None, names=None) -> dict:
    """Phase 13: the sign, step, max/min, Goldschmidt division and inverse
    circuits (or those in ``names``) on the wide evaluator at logN 14 (the
    chain of tests/test_comparison_inverse.py), on ``keys`` (secret,
    relinearization, galois) or the port's own made on ``dev``; each held to
    tests/test_comparison_inverse.py's bounds."""
    from matrix_fhe_tpu_torch.circuits.ckks import comparison, inverse, minimax
    from matrix_fhe_tpu_torch.fast import weval
    from matrix_fhe_tpu_torch.rlwe import decryptor, encryptor
    from matrix_fhe_tpu_torch.rlwe import keys as K
    from matrix_fhe_tpu_torch.schemes import ckks
    params = ckks.new_parameters(ckks.CKKSParametersLiteral(
        logn=LOGN, logq=(60,) + (45,) * 18, logp=(61, 61), log_default_scale=45), device=dev)
    if keys is None:
        sk = K.gen_secret_key(_gen(301), params)
        rlk = K.gen_relinearization_key(_gen(302), params, sk)
        gal = params.galois_element_inverse()
        keys = sk, rlk, {gal: K.gen_galois_key(_gen(303), params, sk, gal)}
    sk, rlk, gks = keys
    wev = weval.make_wide_evaluator(params, rlk, gks)
    enc = ckks.Encoder(params)
    vals = circuit_inputs(params.max_slots)
    cts = {k: encryptor.encrypt(_gen(310 + i), params, sk, enc.encode(v))
           for i, (k, v) in enumerate(vals.items())}
    sign_poly = _timed(times, "sign polynomial (host)", dev,
                       lambda: minimax.gen_minimax_composite_polynomial(4, 20, [7, 7]))
    mm_ev = minimax.Evaluator(wev, enc)
    cmp_ev, inv_ev = comparison.Evaluator(mm_ev, sign_poly), inverse.Evaluator(mm_ev)
    circuits = {
        "sign": lambda: cmp_ev.sign(cts["sign"]), "step": lambda: cmp_ev.step(cts["step"]),
        "max": lambda: cmp_ev.max(cts["a"], cts["b"]), "min": lambda: cmp_ev.min(cts["a"], cts["b"]),
        "goldschmidt_division": lambda: inv_ev.goldschmidt_division(cts["goldschmidt"], -2.0),
        "evaluate_positive_domain": lambda: inv_ev.evaluate_positive_domain(
            cts["inverse"], -2.0, 2.0)}
    want = {"sign": np.sign(vals["sign"]), "step": (np.sign(vals["step"]) + 1) / 2,
            "max": np.maximum(vals["a"], vals["b"]), "min": np.minimum(vals["a"], vals["b"]),
            "goldschmidt_division": 1 / vals["goldschmidt"],
            "evaluate_positive_domain": 1 / vals["inverse"]}
    out, counts, errs, ok = {}, {}, {}, {}
    for name, fn in circuits.items():
        if names is not None and name not in names:
            continue
        out[name], counts[name] = _b4_counted(dev, lambda: _timed(times, name, dev, fn))
        got = np.real(enc.decode(decryptor.decrypt(params, sk, out[name])))
        err = np.abs(got - want[name])
        errs[name] = float(err.max())
        # the inverse's bound is np.testing's atol + rtol |1/x|, 0.01 each
        tol = CIRCUIT_BOUNDS[name] * (1 + np.abs(want[name])) \
            if name == "evaluate_positive_domain" else CIRCUIT_BOUNDS[name]
        ok[name] = bool(np.all(err <= tol))
    return {"out": out, "keys": keys, "errs": errs, "ok": ok, "counts": counts}


def wide_phases(dev, smi: str, rng, sms: int, int32_ops_per_s: float, clock: PhaseClock,
                b4_calls: dict, b4_launches: dict) -> dict:
    """Phases 10-13 (see the module's docstring); returns what the kernels
    line reports of B4, and B4's loss by shape over phases 8-13 (the calls
    and launches of phases 8 and 9 come in ``b4_calls`` / ``b4_launches``,
    ``b4_shapes``'s records, and those of 11-13 are added)."""
    from matrix_fhe_tpu_torch.circuits.ckks import bootstrapping as btp
    from matrix_fhe_tpu_torch.fast import fboot
    from matrix_fhe_tpu_torch.ops import ntt64_cuda
    from matrix_fhe_tpu_torch.schemes import ckks
    from tools import ntt_sass

    # -- 10. B4 alone ----------------------------------------------------------------
    size_rows = check_b4_sizes(dev, rng, sms)
    for logn, shape, picked, cs, f_ms, b_ms, what, err in size_rows:
        assert err == 0, f"B4 {list(shape)} {what}: kernel != plain at C in {cs} ({err} words)"
        print(f"phase b4: {str(list(shape)):20s} {what + ' ' if what else ''}C={picked} (rule), "
              f"kernel == plain at C in "
              f"{cs}, forward and inverse; inverse(forward(x)) == x; device time queued "
              f"fwd {f_ms * 1e3:.1f} us, bwd {b_ms * 1e3:.1f} us | {smi}")
    b4_funcs = ntt_sass.parse(ntt_sass.disassemble([LOGN], ntt64_cuda.SOURCE))
    b4_regs = ntt_sass.ptxas_report(ntt_sass.build_logs(B4_SIZES, ntt64_cuda.SOURCE))
    b4_instr = {}
    for d in ("fwd", "bwd"):
        for c in (1, 8, 16):
            name = f"ntt64_{d}_kernel<{LOGN}, {c}>"
            instrs, flies = ntt_sass.hot_pass64(b4_funcs[name])
            if flies:   # C = 1 loops over groups; the clusters' passes are unrolled
                b4_instr[d] = instrs / flies
            hot = (f"hot pass {instrs} instructions / {flies} butterflies = "
                   f"{instrs / flies:.2f} a butterfly" if flies else "passes unrolled")
            print(f"phase b4: {name} {hot}; {b4_regs[name]['registers']} registers, "
                  f"{b4_regs[name]['spill_bytes']} spill bytes")
    spills = {k: v["spill_bytes"] for k, v in b4_regs.items() if v.get("spill_bytes")}
    print(f"phase b4: {len(b4_regs)} B4 kernels built, registers "
          f"{min(v['registers'] for v in b4_regs.values())}-"
          f"{max(v['registers'] for v in b4_regs.values())}, spills {spills or 'none'}")

    clock.done(10)

    # -- 11. the wide step at bench.py's shapes ------------------------------------------
    b4_seen: dict = {}
    steps, step_shapes = {}, {}
    to_hold = {}
    for name in WIDE_SHAPES:
        seen: dict = {}
        steps[name] = b4_shapes(lambda: wide_step(name, dev), seen, b4_launches)
        b4_seen.update(seen)
        if name == "pn14qp438":
            step_shapes = seen
        st = steps[name]
        rq = st["ctx"].ring_q
        print(f"phase wide step: {name}: logN {LOGN}, Q {len(rq.moduli_tuple)} x "
              f"{[q.bit_length() for q in rq.moduli_tuple]}-bit, P "
              f"{[p.bit_length() for p in st['ctx'].ring_p.moduli_tuple]}-bit, "
              f"{len(st['ctx'].gal_els)} galois keys")
        for r, (m, rot) in enumerate(st["lat"]):
            print(f"phase wide step: {name} request {r}: mul_relin_rescale {m:.3f} ms, "
                  f"rotations_hoisted x{NUM_ROT} {rot:.3f} ms | {smi}")
        for k, v in st["reps"].items():
            print(f"phase wide step: {name} steady {k}: median {statistics.median(v):.3f} ms "
                  f"(min {min(v):.3f}, max {max(v):.3f}, 10 runs) | {smi}")
        print(f"phase wide step: {name} B4 launches a request {st['counts']}; digests equal the "
              f"JAX package's")

    to_hold["wide step"] = {"outs": {name: st["digest"] for name, st in steps.items()}}

    clock.done(11)

    # -- 12. one wide bootstrap at logN 14 -------------------------------------------------
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    wp = btp.Parameters(fboot.wide_parameters_literal(LOGN), device=dev)
    wparams = wp.params
    print(f"phase wide boot: wide_parameters_literal({LOGN}): {len(wparams.q)} + "
          f"{len(wparams.p)} primes of {min(q.bit_length() for q in wparams.q + wparams.p)}-"
          f"{max(q.bit_length() for q in wparams.q + wparams.p)} bits, {wparams.max_slots} "
          f"slots, residual level {wp.residual_level}, {len(wp.galois_elements())} galois "
          f"keys, sparse secret weight {wp.lit.ephemeral_secret_weight}")
    wtimes: dict = {}
    (wsk, wevk), b4_wkeys = _b4_counted(dev, lambda: b4_shapes(
        lambda: boot_keys(wp, wtimes), b4_seen, b4_launches))
    wboot = b4_shapes(lambda: wide_boot_session(wp, wsk, wevk, wtimes), b4_seen, b4_launches)
    wpeak = torch.cuda.max_memory_allocated()
    wwarm_times: dict = {}
    wkeys2 = boot_keys(wp, wwarm_times)
    wwarm = wide_boot_session(wp, *wkeys2, wwarm_times, repeats=BOOT_REPEATS)
    assert _same(wkeys2, (wsk, wevk)), "wide bootstrap keys: warm pass != cold pass"
    for what in ("ct", "boot", "dec", "counts"):
        assert _same(wwarm[what], wboot[what]), f"wide bootstrap {what}: warm pass != cold pass"
    wout = wboot["boot"]
    assert wout.level == wp.residual_level and wout.scale == wparams.default_scale
    assert wboot["counts"]["bootstrap"]["fwd"] > 0 and wboot["counts"]["B1"] == 0
    for name, ms in wtimes.items():
        print(f"phase wide boot: {name:34s} cold {ms:10.3f} ms, warm {wwarm_times[name]:10.3f} ms"
              f" | {smi}")
    print(f"phase wide boot: bootstrap, warm, {BOOT_REPEATS} more: "
          f"{', '.join(f'{t:.3f}' for t in wwarm['repeats'])} ms, median "
          f"{statistics.median(wwarm['repeats']):.3f} ms | {smi}")
    print(f"phase wide boot: peak device memory {(wpeak - held) / 2**20:.1f} MiB above the "
          f"{held / 2**20:.1f} MiB the earlier phases hold | {smi}")
    print(f"phase wide boot: B4 launches a bootstrap {wboot['counts']['bootstrap']}, "
          f"make_wide_bootstrapper {wboot['counts']['make_wide_bootstrapper']}, keygen "
          f"{b4_wkeys}; B1 launches a bootstrap {wboot['counts']['B1']} (cold == warm)")
    wst = ckks.precision_stats(wboot["v"], wboot["dec"])
    floor_met = (wst.avg_precision >= WIDE_BOOT_FLOOR["mean"]
                 and wst.min_precision >= WIDE_BOOT_FLOOR["min"])
    print(f"phase wide boot: decoded precision of bootstrap: mean {wst.avg_precision:.4f} bits, "
          f"min {wst.min_precision:.4f} bits over {len(wboot['dec'])} slots (the JAX package's "
          f"criterion: mean >= {WIDE_BOOT_FLOOR['mean']}, min >= {WIDE_BOOT_FLOOR['min']}: "
          f"{'met' if floor_met else 'MISSED'}) | {smi}")
    wrows, wstaged = boot_stages(wboot["bts"], wsk, wboot["ct"], wboot["v"])
    assert _same(wstaged, wout), "wide: the stages composed != bootstrap"
    for stage, ct_s, own, total, note in wrows:
        print(f"phase wide boot: stage {stage:13s} level {ct_s.level:2d} scale 2^"
              f"{np.log2(float(ct_s.scale)):6.2f} | own mean {own[0]:8.4f} min {own[1]:8.4f} "
              f"bits | total mean {total[0]:8.4f} min {total[1]:8.4f} bits | {note}")
    # held to the same session on the CPU (a worker process, the plain NTT) after phase 25
    to_hold["wide boot"] = {"keys": _tree_digest((wsk, wevk)),
                         **{k: wboot[k] for k in CPU_REFERENCES["wide boot"] if k != "keys"}}
    assert floor_met, "wide bootstrap: decoded precision below the JAX package's criterion"
    wrepeats = wwarm["repeats"]
    del wwarm, wkeys2

    clock.done(12)

    # -- 13. the comparison and inverse circuits on the wide evaluator ----------------------
    ctimes: dict = {}
    circ = b4_shapes(lambda: wide_circuits(dev, ctimes), b4_seen, b4_launches)
    for name, err in circ["errs"].items():
        print(f"phase circuits: {name:24s} {ctimes[name]:10.3f} ms, level out "
              f"{circ['out'][name].level}, max |error| {err:.3e} (bound "
              f"{CIRCUIT_BOUNDS[name]}{' (1 + |1/x|)' if name == 'evaluate_positive_domain' else ''}"
              f"), B4 launches {circ['counts'][name]} | {smi}")
        assert circ["ok"][name], f"{name}: outside the JAX test's bound"
    print(f"phase circuits: sign polynomial {ctimes['sign polynomial (host)']:.1f} ms on the host")
    to_hold["circuits"] = {"keys": _tree_digest(circ["keys"]), "out": circ["out"]}

    clock.done(13)

    # -- 10, continued: B4 at every shape phases 11-13 gave it --------------------------------
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    shape_rows = check_b4_shapes(b4_seen, dev, rng)
    for d, shape, c, err, _ in shape_rows:
        assert err == 0, f"B4 {d} {shape}: kernel != plain ({err})"
    print(f"phase b4: B4 at the {len(shape_rows)} shapes (direction, shape, moduli) of phases "
          f"11-13: kernel == plain at every one")
    b4_stats = {d: {"max_abs_err": 0, "ms": 0.0, "plain_ms": 0.0} for d in ("fwd", "bwd")}
    b4_extra = {d: {"device": 0.0, "flushed": 0.0, "host": 0.0} for d in ("fwd", "bwd")}
    b4_bounds = {"fwd": [], "bwd": []}
    for d, shape, c, err, ring in shape_rows:
        if (d, shape, ring.moduli_tuple) not in step_shapes:
            continue
        t = time_b4(d, shape, ring, dev, rng, flush)
        rows_n = int(np.prod(shape[:-1]))
        b = _b4_bound(rows_n, shape[-2], shape[-1], d == "fwd", int32_ops_per_s)
        b4_bounds[d].append(b)
        b4_stats[d]["ms"] += t["ms"]
        b4_stats[d]["plain_ms"] += t["plain_ms"]
        for k in b4_extra[d]:
            b4_extra[d][k] += t[k]
        print(f"phase b4: step {d} {str(list(shape)):18s} C={c} kernel {t['ms']:.4f} ms, device "
              f"queued {t['device']:.4f} ms, L2 flushed {t['flushed']:.4f} ms, host "
              f"{t['host']:.4f} ms a call | plain {t['plain_ms']:.4f} ms | bound bytes "
              f"{b[0] * 1e3:.3f} us, operations {b[1] * 1e3:.3f} us | {smi}")
    for d in ("fwd", "bwd"):
        b4_stats[d].update(_bound_entry(b4_bounds[d]),
                           sass_instructions_a_butterfly=b4_instr[d])
        print(f"phase b4: the PN14QP438 step's {len(b4_bounds[d])} {d} shapes summed: kernel "
              f"{b4_stats[d]['ms']:.4f} ms, device queued {b4_extra[d]['device']:.4f} ms, L2 "
              f"flushed {b4_extra[d]['flushed']:.4f} ms, host {b4_extra[d]['host']:.4f} ms, plain "
              f"{b4_stats[d]['plain_ms']:.4f} ms, bound {b4_stats[d]['bound_ms']:.4f} ms by "
              f"{b4_stats[d]['bound_by']} | {smi}")
    for d, shape, c, err, _ in shape_rows:
        print(f"phase b4:   {d} {str(list(shape)):20s} C={c}")
    del flush
    def total(*counts):
        return {d: sum(c[d] for c in counts) for d in ("fwd", "bwd")}

    by_path = {
        "wide step PN14QP438 (phase 11, a request)": total(*steps["pn14qp438"]["counts"].values()),
        "wide step wide61 (phase 11, a request)": total(*steps["wide61"]["counts"].values()),
        "wide bootstrap (phase 12)": wboot["counts"]["bootstrap"],
        "wide bootstrap setup (phase 12: keygen, make_wide_bootstrapper)":
            total(b4_wkeys, wboot["counts"]["make_wide_bootstrapper"]),
        "circuits (phase 13)": total(*circ["counts"].values())}
    clock.done(10)

    # -- 13, continued: B4's loss by shape over phases 8-13 ---------------------------------
    loss = b4_loss({**b4_calls, **b4_seen}, b4_launches, dev, rng, int32_ops_per_s, smi,
                   "phases 8-13")
    return {"size_rows": size_rows, "shape_rows": shape_rows, "stats": b4_stats,
            "by_path": by_path, "loss": loss, "to_hold": to_hold,
            "wide_boot": {"p": wp, "sk": wsk, "evk": wevk, "bts": wboot["bts"],
                          # for phase 27
                          "ct": wboot["ct"], "boot": wout, "repeats": wrepeats,
                          "counts": {"B4": wboot["counts"]["bootstrap"],
                                     "B1": {"fwd": 0, "bwd": 0}},
                          "stage_rows": wrows}}

# -- phases 14-16: the fork's rings: B5, Matrix-CKKS at N = 12288, CKKS on the CI ring --

def _b5_counted(dev, fn):
    """fn() and B5's launches in it."""
    from matrix_fhe_tpu_torch.ops import ntt3n_cuda
    return _counted_in(ntt3n_cuda, dev, fn)


def _ci_counted(dev, fn):
    """fn() and B4's launches on the CI ring in it, and on the standard ring
    (the graphs' replays with them)."""
    from matrix_fhe_tpu_torch.ops import ntt64_cuda
    _sync(dev)
    ntt64_cuda.ci_fwd_launches = ntt64_cuda.ci_bwd_launches = 0
    ntt64_cuda.fwd_launches = ntt64_cuda.bwd_launches = 0
    (out, std), ci = _launched(ntt64_cuda, lambda: _launched(ntt64_cuda, fn), CI_ENTRIES,
                               ("ci_fwd_launches", "ci_bwd_launches"))
    _sync(dev)
    return out, {"fwd": ci["fwd"], "bwd": ci["bwd"], "standard": std["fwd"] + std["bwd"]}


def b5_shapes(fn, seen: dict):
    """fn() with every B5 call recorded into ``seen``."""
    from matrix_fhe_tpu_torch.ops import ntt3n_cuda
    return _shapes_in(ntt3n_cuda, fn, seen)


def _b5_roots(n: int, fwd: bool) -> int:
    """The distinct constants other than 1 one limb's B5 transform of degree
    N multiplies by: for M = N/2, the twists omega^j and omega^-j (j < M;
    the inverse's scaled by M^-1), each stage's twiddles omega_Ms^(j t)
    (the radix-r stage of block size Ms: t < r, j < Ms/r; omega_Ms =
    omega^(6M/Ms)), z = omega^M and the cube root omega^(+-2M) in the
    radix-3 butterfly, and the inverse's (z - z^5)^-1.  Exponents of omega
    are taken mod 3N, so a twiddle that equals a twist counts once."""
    from matrix_fhe_tpu_torch.ops import ntt_3n
    lay = ntt_3n.kernel_layout(n)
    m, p, sign = lay["m"], lay["p"], 1 if fwd else -1
    twists = {("w" if fwd else "s", e * j % (6 * m)) for j in range(m) for e in (1, -1)}
    roots = {sign * 6 * (m // ms) * j * t % (6 * m)
             for i, ms in enumerate(lay["blocks"]) for t in range(1, 2 if i < p else 3)
             for j in range(ms // (2 if i < p else 3))}
    roots |= {m, sign * 2 * m % (6 * m)} if lay["b"] else {m}
    vals = twists | {("w", e) for e in roots} | (set() if fwd else {("crt", 0)})
    return len(vals - {("w", 0)})


def _b5_bound(rows: int, limbs: int, n: int, fwd: bool, int32_ops_per_s):
    """(bytes time, operations time) in ms of one B5 transform of ``rows``
    (row, limb) pairs over ``limbs`` limbs, from the mixed-radix transform.
    Operations: its products by a constant other than 1, each a Shoup
    product (MULS_SHOUP multiply-adds on the FMA pipe).  For each of a
    (row, limb)'s two branches of M = N/2 = 2^p 3^b words, the radix-2
    stage of block size Ms takes (M/Ms)(Ms/2 - 1) (twiddle omega_Ms^j,
    j >= 1) and the radix-3 stage M/3 (the cube root, once a butterfly) +
    2 (M/Ms)(Ms/3 - 1) (omega_Ms^j and omega_Ms^2j, j >= 1); for each
    j < M, the fold and the two twists (forward: 3, less the two twists
    by 1 at j = 0) or the two untwists and the CRT solve ((z - z^5)^-1
    and z; inverse: 4):
        rows (2 sum_stages + (3 M - 2 | 4 M)) MULS_SHOUP / (FMA rate).
    Bytes: 8 B a word in and out, and 8 B each distinct constant of a limb
    (``_b5_roots``), read once; no Shoup quotient, no copy."""
    from matrix_fhe_tpu_torch.ops import ntt_3n
    lay = ntt_3n.kernel_layout(n)
    m, p = lay["m"], lay["p"]
    stages = sum((m // ms) * (ms // 2 - 1) if i < p else m // 3 + 2 * (m // ms) * (ms // 3 - 1)
                 for i, ms in enumerate(lay["blocks"]))
    nbytes = 8 * n * 2 * rows + 8 * _b5_roots(n, fwd) * limbs
    products = 2 * stages + (3 * m - 2 if fwd else 4 * m)
    return (nbytes / HBM_BYTES_PER_S * 1e3,
            rows * products * MULS_SHOUP / (int32_ops_per_s / 2) * 1e3)


def check_b5_sizes(dev, rng) -> list:
    """B5 against its plain version at every size of B5_SIZES (three primes
    of 45, 55 and 60 bits, [2, 3, N]), on the card at the cluster size the
    wrapper picks and at every size it takes, and, for one row, on the CPU;
    N = 6 runs the dense transform with no launch.  One row a size."""
    from matrix_fhe_tpu_torch.ops import ntt3n_cuda, rings
    from matrix_fhe_tpu_torch.utils import primes as pr
    out = []
    for n in B5_SIZES:
        moduli = [pr.find_3n_rns_primes(n, b, 1)[0] for b in (45, 55, 60)]
        ring = rings.new_ring(n, moduli, rings.MATRIX, device=dev)
        cpu = rings.new_ring(n, moduli, rings.MATRIX, device="cpu")
        x_cpu = _words(rng, (2,), moduli, n)
        x = x_cpu.to(dev)
        (f, b), counts = _b5_counted(dev, lambda: (ring.ntt(x), ring.intt(x)))
        err = 0
        if ring.ntt3n is None:
            assert counts == {"fwd": 0, "bwd": 0}, f"N={n}: the dense transform launched B5"
            err = int((f.cpu() != cpu.ntt(x_cpu)).sum() + (b.cpu() != cpu.intt(x_cpu)).sum())
        else:
            assert counts == {"fwd": 1, "bwd": 1}, (n, counts)
            want_f, want_b = ntt3n_cuda.ntt_fwd_plain(x, ring), ntt3n_cuda.ntt_bwd_plain(x, ring)
            err += int((f != want_f).sum()) + int((b != want_b).sum())
            for c in ntt3n_cuda.clusters(n):
                err += int((ntt3n_cuda.launch(x, ring, True, c) != want_f).sum())
                err += int((ntt3n_cuda.launch(x, ring, False, c) != want_b).sum())
            err += int((f[0].cpu() != ntt3n_cuda.ntt_fwd_plain(x_cpu[0], cpu)).sum())
            err += int((b[0].cpu() != ntt3n_cuda.ntt_bwd_plain(x_cpu[0], cpu)).sum())
        assert torch.equal(ring.intt(f), x), f"B5 N={n}: inverse(forward(x)) != x"
        out.append((n, ring.ntt3n is not None and ntt3n_cuda.clusters(n), counts, err))
    return out


def check_b5_shapes(shapes: dict, dev, rng) -> list:
    """B5 against its plain version on the card at each recorded shape (its
    moduli, random words): (direction, shape, mismatched words, ring)."""
    from matrix_fhe_tpu_torch.ops import ntt3n_cuda
    rows = []
    for (d, shape, _), ring in sorted(shapes.items(), key=lambda kv: (kv[0][1], kv[0][0])):
        kern = ntt3n_cuda.ntt_fwd if d == "fwd" else ntt3n_cuda.ntt_bwd
        plain = ntt3n_cuda.ntt_fwd_plain if d == "fwd" else ntt3n_cuda.ntt_bwd_plain
        x = _words(rng, shape[:-2], ring.moduli_tuple, shape[-1]).to(dev)
        rows.append((d, shape, int((kern(x, ring) != plain(x, ring)).sum()), ring))
    return rows


def check_ci_shapes(shapes: dict, dev, rng) -> list:
    """B4 on the CI ring (``ntt_ci_fwd``/``ntt_ci_bwd``: the kernel's CI
    mode, the fold inside) against its plain version on the card at each
    recorded shape; the kernels of three calls captured into a CUDA graph
    (one B4 launch each) and the torch operators a call dispatches (the
    output's allocation alone): (direction, shape, mismatched words, ring,
    kernels, ops)."""
    from matrix_fhe_tpu_torch.ops import ntt64_cuda
    from matrix_fhe_tpu_torch.utils import launches
    rows = []
    for (d, shape, _), ring in sorted(shapes.items(), key=lambda kv: (kv[0][1], kv[0][0])):
        kern = ntt64_cuda.ntt_ci_fwd if d == "fwd" else ntt64_cuda.ntt_ci_bwd
        plain = ntt64_cuda.ntt_ci_fwd_plain if d == "fwd" else ntt64_cuda.ntt_ci_bwd_plain
        x = _words(rng, shape[:-2], ring.moduli_tuple, shape[-1]).to(dev)
        rows.append((d, shape, int((kern(x, ring) != plain(x, ring)).sum()), ring,
                     launches.graph_kernels(lambda: kern(x, ring)),
                     launches.torch_ops(lambda: kern(x, ring))))
    return rows


def time_b5(d, shape, ring, dev, rng, flush) -> dict:
    """As ``time_b4``; the plain version (7-12 ms a call) 5 times."""
    from matrix_fhe_tpu_torch.ops import ntt3n_cuda
    return _time_in(ntt3n_cuda, d, shape, ring, dev, rng, flush, plain_iters=5)


def ring_product(a, b):
    """a b mod X^N - X^{N/2} + 1, in float64 (reduce with X^N = X^{N/2} - 1)."""
    n = len(a)
    prod = np.zeros(2 * n)
    for i in range(n):
        prod[i:i + n] += a[i] * b
    for k in range(n - 1, -1, -1):
        prod[k + n // 2] += prod[n + k]
        prod[k] -= prod[n + k]
    return prod[:n]


def automorphism_model(v, g):
    """v(X^g) mod X^N - X^{N/2} + 1: reduce with X^{3N/2} = -1, then with
    X^N = X^{N/2} - 1."""
    n = len(v)
    full = np.zeros(3 * n)
    np.add.at(full, (np.arange(n) * g) % (3 * n), v)
    h = 3 * n // 2
    full[:h] -= full[h:]
    for e in range(h - 1, n - 1, -1):
        full[e - n + n // 2] += full[e]
        full[e - n] -= full[e]
    return full[:n]


def matrix_keys(params, gal_els, times: dict):
    """The secret, relinearization and galois keys: the draws on CPU
    generators, then the deterministic part, timed apart."""
    from matrix_fhe_tpu_torch.rlwe import keys as K
    dev = params.device

    def draws():
        return (K.sample_secret(_gen(301), params), K.sample_evaluation_key(_gen(302), params),
                {g: K.sample_evaluation_key(_gen(310 + i), params) for i, g in enumerate(gal_els)})

    def keys(small, rlk_s, gk_s):
        sk = K.secret_key_from_sample(params, small)
        return (sk, K.relinearization_key_from_samples(params, sk, rlk_s),
                {g: K.galois_key_from_samples(params, sk, g, s) for g, s in gk_s.items()})

    samples = _timed(times, f"keygen draws (secret, relinearization, {len(gal_els)} galois)",
                     dev, draws)
    return _timed(times, "keygen deterministic part", dev, lambda: keys(*samples))


def matrix_ops(params, rlk, gks):
    """Phase 15's operations, name -> fn(ct1, ct2)."""
    from matrix_fhe_tpu_torch.schemes import matrix_ckks as mc
    ev = mc.Evaluator(params)
    ops = {"add": lambda a, b: ev.add(a, b),
           "mul_const(0.5) + rescale": lambda a, b: ev.rescale(ev.mul_const(a, 0.5)),
           "mul_relin + rescale": lambda a, b: ev.rescale(ev.mul_relin(a, b, rlk))}
    for g in gks:
        ops[f"automorphism {g}"] = lambda a, b, g=g: ev.automorphism(a, gks[g])
    return ops


def matrix_session(dev, times: dict, keys=None) -> dict:
    """Phase 15 on ``dev``: the parameters, the keys (or ``keys``, moved
    over), encode + encrypt of two vectors, each operation once (its B5
    launches counted), decrypt + decode."""
    from matrix_fhe_tpu_torch.rlwe import decryptor, encryptor
    from matrix_fhe_tpu_torch.schemes import matrix_ckks as mc
    params = _timed(times, "parameters", dev, lambda: mc.new_parameters(
        mc.MatrixCKKSParametersLiteral(**MATRIX_LITERAL), device=dev))
    gal_els = [5, 3 * params.n - 1]
    if keys is None:
        keys, counts_keys = _b5_counted(dev, lambda: matrix_keys(params, gal_els, times))
    else:
        keys, counts_keys = _move(keys, dev), None
    sk, rlk, gks = keys
    enc = mc.Encoder(params)
    rng = np.random.default_rng(SEED)
    v1, v2 = rng.uniform(-1, 1, params.n), rng.uniform(-1, 1, params.n)
    cts = _timed(times, "encode + encrypt x2", dev, lambda: [
        encryptor.encrypt(_gen(320 + i), params, sk, enc.encode(v)) for i, v in enumerate((v1, v2))])
    outs, counts = {}, {}
    for name, fn in matrix_ops(params, rlk, gks).items():
        outs[name], counts[name] = _b5_counted(dev, lambda: _timed(times, name, dev,
                                                                  lambda: fn(*cts)))
    dec = {name: enc.decode(decryptor.decrypt(params, sk, ct)) for name, ct in outs.items()}
    _timed(times, "decrypt + decode", dev,
           lambda: enc.decode(decryptor.decrypt(params, sk, outs["add"])))
    return {"params": params, "keys": keys, "cts": cts, "outs": outs, "dec": dec,
            "counts": counts, "counts_keys": counts_keys, "v": (v1, v2)}


def ci_session(dev, times: dict, keys=None) -> dict:
    """Phase 16 on ``dev``: CKKS on the CI ring, keys from CPU generators
    (or ``keys``), mul_relin + rescale and a rotation by one slot."""
    from matrix_fhe_tpu_torch.rlwe import decryptor, encryptor
    from matrix_fhe_tpu_torch.rlwe import keys as K
    from matrix_fhe_tpu_torch.schemes import ckks
    from tools.port_precision_floor import CI_LITERAL, CI_ROTATION, ci_vectors
    params = ckks.new_parameters(ckks.CKKSParametersLiteral(**CI_LITERAL), device=dev)
    g = params.galois_element(CI_ROTATION)
    counts = {}
    if keys is None:
        def gen_keys():
            sk = K.gen_secret_key(_gen(401), params)
            return (sk, K.gen_relinearization_key(_gen(402), params, sk),
                    K.gen_galois_key(_gen(403), params, sk, g))
        keys, counts["keygen"] = _ci_counted(dev, lambda: _timed(times, "keygen", dev, gen_keys))
    else:
        keys = _move(keys, dev)
    sk, rlk, gk = keys
    enc = ckks.Encoder(params)
    ev = ckks.Evaluator(params, rlk=rlk, galois_keys={g: gk})
    v1, v2 = ci_vectors(params.max_slots)
    cts, counts["encode + encrypt"] = _ci_counted(dev, lambda: _timed(
        times, "encode + encrypt x2", dev, lambda: [
            encryptor.encrypt(_gen(410 + i), params, sk, enc.encode(v))
            for i, v in enumerate((v1, v2))]))
    outs = {}
    for name, fn in (("mul_relin + rescale", lambda: ev.rescale(ev.mul_relin(*cts))),
                     (f"rotate {CI_ROTATION}", lambda: ev.rotate(cts[0], CI_ROTATION))):
        outs[name], counts[name] = _ci_counted(dev, lambda: _timed(times, name, dev, fn))
    dec, counts["decrypt + decode"] = _ci_counted(dev, lambda: _timed(
        times, "decrypt + decode x2", dev, lambda: {
            k: enc.decode(decryptor.decrypt(params, sk, ct)) for k, ct in outs.items()}))
    prec = {"product": ckks.precision_stats(v1 * v2, dec["mul_relin + rescale"]),
            "rotation": ckks.precision_stats(np.roll(v1, -CI_ROTATION), dec[f"rotate {CI_ROTATION}"])}
    return {"params": params, "keys": keys, "cts": cts, "outs": outs, "dec": dec,
            "prec": prec, "counts": counts}


def matrix_phases(dev, smi: str, rng, int32_ops_per_s: float, clock: PhaseClock) -> dict:
    """Phases 14-16 (see the module's docstring); returns what the kernels
    line reports of B5 and of B4 on the CI ring."""
    from matrix_fhe_tpu_torch.ops import ntt3n_cuda, ntt64_cuda, ntt_3n, rings
    from matrix_fhe_tpu_torch.rlwe import params as rparams
    from tools import ntt_sass
    from tools.port_reference_digest import THREE_N, three_n_input, words_digest

    # -- 14. B5 alone ------------------------------------------------------------------
    max_err = 0
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for n, cs, counts, err in check_b5_sizes(dev, rng):
        max_err = max(max_err, err)
        assert err == 0, f"B5 N={n}: kernel != plain ({err} words)"
        if cs:
            p, b = ntt_3n.radix_counts(n // 2)
            what = (f"M = 2^{p} 3^{b}, launches {counts}, C = {ntt3n_cuda.geometry(6, n, sms)} "
                    f"picked, every C of {list(cs)} checked")
        else:
            what = f"dense transform, no launch {counts}"
        print(f"phase b5: N {n:6d} [2, 3, N]: {what}; kernel == plain (card, and CPU for one "
              f"row), inverse(forward(x)) == x")
    n = (1 << THREE_N["order2"]) * 3 ** THREE_N["order3"]
    q, p = rparams.gen_3n_moduli(n, THREE_N["logq"], THREE_N["logp"])
    ring = rings.new_ring(n, q + p, rings.MATRIX, device=dev)
    x = torch.from_numpy(three_n_input(q + p, n)).to(dev)
    got = {"fwd": words_digest([ring.ntt(x).cpu().numpy()]),
           "bwd": words_digest([ring.intt(x).cpu().numpy()])}
    assert got == NTT3N_SHA256, f"B5 at N={n}: digests {got} != the JAX package's"
    print(f"phase b5: N {n} over the {len(q + p)} primes of phase 15 ([2, 7, N]): forward and "
          f"inverse hash to the JAX package's digests (tools/port_reference_digest.py 3n)")
    funcs = ntt_sass.parse(ntt_sass.disassemble([ntt3n_cuda.BUILD_KEY], ntt3n_cuda.SOURCE))
    regs = ntt_sass.ptxas_report(ntt_sass.build_logs([ntt3n_cuda.BUILD_KEY], ntt3n_cuda.SOURCE))
    per_fly = {}
    path_c = ntt3n_cuda.geometry(6, 12288, sms)
    for d in ("fwd", "bwd"):
        for c in ntt3n_cuda.CLUSTERS:
            name = f"ntt3n_{d}_kernel<{c}>"
            passes = ntt_sass.b5_passes(funcs[name])
            assert all(f for _, f in passes.values()), f"{name}: a pass not found in its SASS"
            if c == path_c:
                per_fly[d] = {k: n_ / f for k, (n_, f) in passes.items()}
            print(f"phase b5: {name}: hot radix-2^k pass {passes['radix-2^k'][0]} instructions "
                  f"/ {passes['radix-2^k'][1]} butterflies = "
                  f"{passes['radix-2^k'][0] / passes['radix-2^k'][1]:.2f} a butterfly, radix-3 "
                  f"pass {passes['radix-3'][0]} instructions a radix-3 butterfly (the bound "
                  f"counts the {MULS_SHOUP} multiply-adds of each Shoup product); "
                  f"{regs[name]['registers']} registers, {regs[name]['spill_bytes']} spill bytes")

    clock.done(14)

    # -- 15. Matrix-CKKS at N = 12288 ---------------------------------------------------
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    mtimes: dict = {}
    seen: dict = {}
    ms = b5_shapes(lambda: matrix_session(dev, mtimes), seen)
    peak = torch.cuda.max_memory_allocated()
    mp = ms["params"]
    print(f"phase matrix: Matrix-CKKS N {mp.n} = 2^{MATRIX_LITERAL['order2']} 3, Q "
          f"{[q.bit_length() for q in mp.q]} bits, P {[p.bit_length() for p in mp.p]} bits, "
          f"scale 2^{MATRIX_LITERAL['log_default_scale']}, galois elements {sorted(ms['keys'][2])}")
    v1, v2 = ms["v"]
    want = {"add": v1 + v2, "mul_const(0.5) + rescale": 0.5 * v1,
            "mul_relin + rescale": ring_product(v1, v2)}
    for g in ms["keys"][2]:
        want[f"automorphism {g}"] = automorphism_model(v1, g)
    ops = matrix_ops(mp, ms["keys"][1], ms["keys"][2])
    warm = {}
    for name, fn in ops.items():
        reps = []
        for _ in range(MATRIX_REPEATS):
            _timed(mtimes, "again", dev, lambda: fn(*ms["cts"]))
            reps.append(mtimes.pop("again"))
        warm[name] = statistics.median(reps)
        err = float(np.abs(ms["dec"][name] - want[name]).max())
        assert err <= MATRIX_BOUND, f"Matrix-CKKS {name}: max |error| {err} > {MATRIX_BOUND}"
        print(f"phase matrix: {name:28s} request {mtimes[name]:9.3f} ms, warm median of "
              f"{MATRIX_REPEATS} {warm[name]:9.3f} ms | B5 launches {ms['counts'][name]} | max "
              f"|error| {err:.3e} ({-np.log2(err):.2f} bits; bound {MATRIX_BOUND}) | {smi}")
    for name in ("parameters", *(k for k in mtimes if k.startswith("keygen")),
                 "encode + encrypt x2", "decrypt + decode"):
        print(f"phase matrix: {name:60s} {mtimes[name]:10.3f} ms | {smi}")
    print(f"phase matrix: B5 launches keygen {ms['counts_keys']}; peak device memory "
          f"{(peak - held) / 2**20:.1f} MiB above the {held / 2**20:.1f} MiB the earlier phases "
          f"hold | {smi}")
    to_hold = {"matrix": _held(ms, "matrix")}

    clock.done(15)

    # -- 14, continued: B5 at every shape phase 15 gave it -------------------------------
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    shape_rows = check_b5_shapes(seen, dev, rng)
    stats = {d: {"max_abs_err": max_err, "ms": 0.0, "plain_ms": 0.0} for d in ("fwd", "bwd")}
    extra = {d: {"device": 0.0, "flushed": 0.0, "host": 0.0} for d in ("fwd", "bwd")}
    bounds = {"fwd": [], "bwd": []}
    for d, shape, err, r in shape_rows:
        assert err == 0, f"B5 {d} {shape}: kernel != plain ({err})"
        t = time_b5(d, shape, r, dev, rng, flush)
        rows_n = int(np.prod(shape[:-1]))
        b = _b5_bound(rows_n, shape[-2], shape[-1], d == "fwd", int32_ops_per_s)
        bounds[d].append(b)
        stats[d]["ms"] += t["ms"]
        stats[d]["plain_ms"] += t["plain_ms"]
        for k in extra[d]:
            extra[d][k] += t[k]
        print(f"phase b5: {d} {str(list(shape)):18s} C={ntt3n_cuda.geometry(rows_n, shape[-1], sms)}"
              f" kernel {t['ms']:.4f} ms, device queued "
              f"{t['device']:.4f} ms, L2 flushed {t['flushed']:.4f} ms, host {t['host']:.4f} ms "
              f"a call | plain {t['plain_ms']:.4f} ms | bound bytes {b[0] * 1e3:.3f} us, "
              f"operations {b[1] * 1e3:.3f} us | {smi}")
    del flush
    for d in ("fwd", "bwd"):
        stats[d].update(_bound_entry(bounds[d]), sass_instructions_a_butterfly=per_fly[d],
                        **{f"{k}_ms": v for k, v in extra[d].items()})
        print(f"phase b5: phase 15's {len(bounds[d])} {d} shapes, kernel == plain at each; summed: "
              f"kernel {stats[d]['ms']:.4f} ms, device queued {extra[d]['device']:.4f} ms, L2 "
              f"flushed {extra[d]['flushed']:.4f} ms, host {extra[d]['host']:.4f} ms, plain "
              f"{stats[d]['plain_ms']:.4f} ms, bound {stats[d]['bound_ms']:.4f} ms by "
              f"{stats[d]['bound_by']} | {smi}")

    clock.done(14)

    # -- 16. CKKS on the CI ring at logN 14 ----------------------------------------------
    from tools.port_precision_floor import CI_LITERAL
    citimes: dict = {}
    ci_seen: dict = {}
    ci_launches: dict = {}
    ci = _shapes_in(ntt64_cuda, lambda: ci_session(dev, citimes), ci_seen, CI_ENTRIES, ci_launches)
    cp = ci["params"]
    print(f"phase ci: CKKS on the conjugate-invariant ring, logN {cp.log_n}, {cp.max_slots} real "
          f"slots, Q {[q.bit_length() for q in cp.q]} bits, P {[p.bit_length() for p in cp.p]} "
          f"bits, scale 2^{CI_LITERAL['log_default_scale']}")
    for name, ms_ in citimes.items():
        print(f"phase ci: {name:24s} {ms_:10.3f} ms | B4 launches (CI ring) "
              f"{ci['counts'].get(name.replace(' x2', ''), '-')} | {smi}")
    for what, st in ci["prec"].items():
        floor = CI_FLOOR[what]
        print(f"phase ci: precision of {what}: min {st.min_precision:.4f} bits, mean "
              f"{st.avg_precision:.4f} bits (floor on the min {floor:.4f}: the JAX package's "
              f"less 1 bit, tools/port_precision_floor.py ci) | {smi}")
        assert st.min_precision >= floor, f"CI {what}: below the floor"
    for what, c in ci["counts"].items():
        assert c["standard"] == 0, f"CI {what}: the standard ring's B4 launched"
    assert ci["counts"]["mul_relin + rescale"]["fwd"] > 0
    to_hold["ci"] = _held(ci, "ci")

    clock.done(16)

    # -- 16, continued: B4 on the CI ring at every shape phase 16 gave it -----------------
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    ci_stats = {d: {"max_abs_err": 0, "ms": 0.0, "plain_ms": 0.0} for d in ("fwd", "bwd")}
    ci_extra = {d: {"device": 0.0, "flushed": 0.0, "host": 0.0} for d in ("fwd", "bwd")}
    ci_bounds = {"fwd": [], "bwd": []}
    for d, shape, err, r, names, ops in check_ci_shapes(ci_seen, dev, rng):
        assert err == 0, f"B4 on the CI ring {d} {shape}: kernel != plain ({err})"
        assert len(names) == 3 and all("ntt64" in k for k in names), \
            f"B4 on the CI ring {d} {shape}: three calls ran {names}, not one B4 launch each"
        assert ops == ["aten.empty_like.default"], \
            f"B4 on the CI ring {d} {shape}: a call ran the torch ops {ops}"
        t = _time_in(ntt64_cuda, d, shape, r, dev, rng, flush, names=CI_ENTRIES)
        b = _b4_bound(int(np.prod(shape[:-1])), shape[-2], shape[-1], d == "fwd",
                      int32_ops_per_s, ci=True)
        ci_bounds[d].append(b)
        ci_stats[d]["ms"] += t["ms"]
        ci_stats[d]["plain_ms"] += t["plain_ms"]
        for k in ci_extra[d]:
            ci_extra[d][k] += t[k]
        print(f"phase ci: B4 on the CI ring {d} {str(list(shape)):18s} one kernel a call "
              f"({names[0]}; no torch op but the output's allocation), kernel {t['ms']:.4f} ms, "
              f"device queued {t['device']:.4f} ms, L2 flushed {t['flushed']:.4f} ms, host "
              f"{t['host']:.4f} ms a call | plain {t['plain_ms']:.4f} ms | bound bytes "
              f"{b[0] * 1e3:.3f} us, operations {b[1] * 1e3:.3f} us | {smi}")
    del flush
    for d in ("fwd", "bwd"):
        ci_stats[d].update(_bound_entry(ci_bounds[d]),
                           **{f"{k}_ms": v for k, v in ci_extra[d].items()})
        print(f"phase ci: phase 16's {len(ci_bounds[d])} {d} shapes of B4 on the CI ring (the "
              f"fold in the launch), kernel == plain at each; summed: kernel "
              f"{ci_stats[d]['ms']:.4f} ms, device queued {ci_extra[d]['device']:.4f} ms, L2 "
              f"flushed {ci_extra[d]['flushed']:.4f} ms, host {ci_extra[d]['host']:.4f} ms, plain "
              f"{ci_stats[d]['plain_ms']:.4f} ms, bound {ci_stats[d]['bound_ms']:.4f} ms by "
              f"{ci_stats[d]['bound_by']} | {smi}")

    def total(counts):
        return {d: sum(c[d] for c in counts) for d in ("fwd", "bwd")}

    b5_by_path = {"Matrix-CKKS keygen (phase 15)": ms["counts_keys"],
                  **{f"Matrix-CKKS {k} (phase 15)": v for k, v in ms["counts"].items()}}
    ci_loss = b4_loss(ci_seen, ci_launches, dev, rng, int32_ops_per_s, smi, "phase 16, CI ring",
                      ci=True)
    return {"b5_stats": stats, "b5_launches": total(ms["counts"].values()), "ci_loss": ci_loss,
            "b5_by_path": b5_by_path, "ci_stats": ci_stats, "to_hold": to_hold,
            "ci_launches": total(ci["counts"].values()),
            "ci_by_path": {k: {"fwd": v["fwd"], "bwd": v["bwd"]}
                           for k, v in ci["counts"].items()},
            "ci_session": {k: ci[k] for k in ("params", "keys", "cts", "outs")},
            "matrix_session": {k: ms[k] for k in ("params", "keys", "cts", "outs")}}

# -- phases 17-20: ring switching and packing, the bridge, the packed bootstrap, BGV/BFV --

def _rs_params(device) -> dict:
    """Phase 17's parameter sets at logN 12-14 on PN14QP438's chain (7 + 2
    primes of 45-55 bits, all 1 mod 2^15)."""
    from matrix_fhe_tpu_torch import rlwe
    from matrix_fhe_tpu_torch.fast import wckks
    return {ln: rlwe.new_parameters(rlwe.ParametersLiteral(
        logn=ln, q=wckks.PN14QP438_Q, p=wckks.PN14QP438_P), device) for ln in RS_LOGNS}


def _coeffs(params, sk, ct, scale) -> np.ndarray:
    """The decrypted coefficients of ``ct``, centered, over ``scale``."""
    from matrix_fhe_tpu_torch.rlwe import decryptor
    from matrix_fhe_tpu_torch.schemes.ckks.encoder import crt_reconstruct_centered
    pt = decryptor.decrypt(params, sk, ct)
    ring = params.ring_q.at_level(pt.level)
    v = ring.intt(pt.value) if pt.metadata.is_ntt else pt.value
    return np.array([float(x) for x in crt_reconstruct_centered(
        v.cpu().numpy(), params.q[:pt.level + 1])]) / scale


def _encrypt_coeffs(params, sk, vals, site: int):
    """The secret-key encryption of the coefficients vals * RS_SCALE."""
    from matrix_fhe_tpu_torch.rlwe import encryptor
    from matrix_fhe_tpu_torch.rlwe.elements import MetaData, Plaintext
    arr = np.stack([(vals * RS_SCALE) % q for q in params.q]).astype(np.int64)
    pt = Plaintext(value=params.ring_q.ntt(torch.from_numpy(arr).to(params.device)),
                   metadata=MetaData(is_ntt=True))
    return encryptor.encrypt(_gen(site), params, sk, pt)


def _rs_inputs():
    rng = np.random.default_rng(SEED)
    return {"switch": rng.integers(-50, 50, 1 << (RS_LOGNS[-1] - 1)),
            "gap": rng.integers(-100, 100, 1 << (RS_LOGNS[-1] - RS_LOG_GAP)),
            "split": rng.integers(-100, 100, 1 << RS_LOGNS[-1]),
            "extract": rng.integers(-100, 100, 1 << (RS_LOGNS[-1] - RS_LOG_GAP))}


def _strided(vals, n: int, gap: int) -> np.ndarray:
    out = np.zeros(n, dtype=np.int64)
    out[::gap] = vals
    return out


def ring_switch_session(dev, times: dict) -> dict:
    """Phase 17 on ``dev``: ring switching 2^13 <-> 2^14, expand -> pack of
    16 values at stride 2^10 at 2^14, and a RingPackingEvaluator over
    2^12-2^14 (split / merge, extract -> repack in three pairings)."""
    from matrix_fhe_tpu_torch.rlwe import keys as K
    from matrix_fhe_tpu_torch.rlwe import ring_packing as rpk
    from matrix_fhe_tpu_torch.rlwe import ring_switch as rs
    params = _rs_params(dev)
    lo, hi = params[RS_LOGNS[-1] - 1], params[RS_LOGNS[-1]]
    v = _rs_inputs()

    def keygen():
        sk_lo, sk_hi = K.gen_secret_key(_gen(501), lo), K.gen_secret_key(_gen(502), hi)
        return sk_lo, sk_hi, rs.gen_ring_swap_keys(_gen(503), lo, hi, sk_lo, sk_hi)

    sk_lo, sk_hi, (up, down) = _timed(times, "keygen: secrets + ring-swap keys", dev, keygen)
    gels = sorted(set(rpk.galois_elements_for_expand(hi))
                  | set(rpk.galois_elements_for_pack(hi, hi.log_n)))
    gks = _timed(times, f"keygen: {len(gels)} galois keys (expand, pack)", dev, lambda: {
        g: K.gen_galois_key(_gen(510 + i), hi, sk_hi, g) for i, g in enumerate(gels)})
    out = {"keys": (sk_lo, sk_hi, up, down, gks)}
    out["ct_lo"] = _encrypt_coeffs(lo, sk_lo, v["switch"], 504)
    out["up"] = _timed(times, "switch_up 2^13 -> 2^14", dev,
                       lambda: rs.switch_up(lo, hi, out["ct_lo"], up))
    out["down"] = _timed(times, "switch_down 2^14 -> 2^13", dev,
                         lambda: rs.switch_down(hi, lo, out["up"], down))
    out["ct_gap"] = _encrypt_coeffs(hi, sk_hi, _strided(v["gap"], hi.n, 1 << RS_LOG_GAP), 505)
    out["expand"] = _timed(times, "expand (log_gap 10, 16 outputs)", dev,
                           lambda: rpk.expand(hi, out["ct_gap"], RS_LOG_GAP, gks))
    out["pack"] = _timed(times, "pack (16 inputs)", dev, lambda: rpk.pack(
        hi, out["expand"], input_log_gap=hi.log_n, zero_garbage_slots=True, gks=gks))

    def make(ln, device):
        return params[ln]

    ev = _timed(times, "RingPackingEvaluator(12, 14) keygen", dev, lambda: rpk.RingPackingEvaluator(
        _gen(520), make, RS_LOGNS[0], RS_LOGNS[-1], device=dev))
    out["ev"] = ev
    out["ct_split"] = _encrypt_coeffs(hi, ev.sk[hi.log_n], v["split"], 521)
    out["split"] = _timed(times, "split 2^14", dev, lambda: ev.split(out["ct_split"], hi.log_n))
    out["merge"] = _timed(times, "merge 2^13 -> 2^14", dev,
                          lambda: ev.merge(*out["split"], hi.log_n))
    out["ct_extract"] = _encrypt_coeffs(hi, ev.sk[hi.log_n],
                                        _strided(v["extract"], hi.n, 1 << RS_LOG_GAP), 522)
    idx = list(range(0, hi.n, 1 << RS_LOG_GAP))
    for name, (ne, nr) in RS_PAIRINGS.items():
        cts = _timed(times, f"extract 16 ({name})", dev,
                     lambda: ev.extract(out["ct_extract"], idx, naive=ne))
        out[f"extract {name}"] = cts
        out[f"repack {name}"] = _timed(times, f"repack 16 ({name})", dev,
                                       lambda: ev.repack(cts, naive=nr))
    out["params"] = params
    return out


def check_ring_switch(s: dict) -> dict:
    """Phase 17's bounds: every coefficient within tests/test_ring_switch.py's
    0.01 and tests/test_ring_packing.py's / test_ring_packing_xdeg.py's bounds;
    returns the max |error| of each check."""
    params = s["params"]
    lo, hi = params[RS_LOGNS[-1] - 1], params[RS_LOGNS[-1]]
    sk_lo, sk_hi = s["keys"][:2]
    v = _rs_inputs()
    gap = 1 << RS_LOG_GAP
    err = {}
    got = _coeffs(hi, sk_hi, s["up"], RS_SCALE)
    want = _strided(v["switch"], hi.n, 2)
    err["switch_up"] = float(np.abs(got - want).max())
    err["switch_down"] = float(np.abs(_coeffs(lo, sk_lo, s["down"], RS_SCALE) - v["switch"]).max())
    e = 0.0
    for j, (i, ct) in enumerate(sorted(s["expand"].items())):
        c = _coeffs(hi, sk_hi, ct, RS_SCALE)
        assert i == j * gap
        e = max(e, abs(c[0] - v["gap"][j]), float(np.abs(c[1:]).max()))
    err["expand"] = e
    err["pack"] = float(np.abs(_coeffs(hi, sk_hi, s["pack"], RS_SCALE)
                               - _strided(v["gap"], hi.n, gap)).max())
    ev = s["ev"]
    small = ev.params[hi.log_n - 1]
    even, odd = s["split"]
    err["split"] = max(float(np.abs(_coeffs(small, ev.sk[hi.log_n - 1], even, RS_SCALE)
                                    - v["split"][::2]).max()),
                       float(np.abs(_coeffs(small, ev.sk[hi.log_n - 1], odd, RS_SCALE)
                                    - v["split"][1::2]).max()))
    err["merge"] = float(np.abs(_coeffs(hi, ev.sk[hi.log_n], s["merge"], RS_SCALE)
                                - v["split"]).max())
    pmin, sk_min = ev.params[RS_LOGNS[0]], ev.sk[RS_LOGNS[0]]
    for name, (ne, _) in RS_PAIRINGS.items():
        e = 0.0
        for j, (i, ct) in enumerate(sorted(s[f"extract {name}"].items())):
            c = _coeffs(pmin, sk_min, ct, RS_SCALE)
            e = max(e, abs(c[0] - v["extract"][j]), 0.0 if ne else float(np.abs(c[1:]).max()))
        err[f"extract {name}"] = e
        err[f"repack {name}"] = float(np.abs(_coeffs(hi, ev.sk[hi.log_n], s[f"repack {name}"],
                                                     RS_SCALE)
                                             - _strided(v["extract"], hi.n, gap)).max())
    for what, e in err.items():
        bound = RS_BOUNDS[what.split()[0]]
        assert e <= bound, f"phase 17 {what}: max |error| {e} > {bound}"
    return err


# what ring_switch_cpu reads of phase 17's session, and of its RingPackingEvaluator
RING_SWITCH_INPUTS = ("keys", "ct_lo", "up", "down", "ct_gap", "expand", "pack", "ct_split",
                      "split", "merge")
RING_PACKING_FIELDS = ("sk", "evk_up", "evk_down", "gks_min", "x_pow2", "x_inv_pow2")


def ring_switch_cpu(s: dict) -> dict:
    """The card's switch_up / switch_down, expand / pack and split / merge
    again on the CPU, from the card's inputs and keys, through the plain
    NTT; returns the CPU's times."""
    from matrix_fhe_tpu_torch.rlwe import ring_packing as rpk
    from matrix_fhe_tpu_torch.rlwe import ring_switch as rs
    cpu = torch.device("cpu")
    params = _rs_params(cpu)
    lo, hi = params[RS_LOGNS[-1] - 1], params[RS_LOGNS[-1]]
    sk_lo, sk_hi, up, down, gks = _move(s["keys"], cpu)
    t: dict = {}
    for name, fn, want in (
            ("switch_up", lambda: rs.switch_up(lo, hi, _move(s["ct_lo"], cpu), up), s["up"]),
            ("switch_down", lambda: rs.switch_down(hi, lo, _move(s["up"], cpu), down),
             s["down"]),
            ("expand", lambda: rpk.expand(hi, _move(s["ct_gap"], cpu), RS_LOG_GAP, gks),
             s["expand"]),
            ("pack", lambda: rpk.pack(hi, _move(s["expand"], cpu), input_log_gap=hi.log_n,
                                      zero_garbage_slots=True, gks=gks), s["pack"])):
        assert _same(want, _timed(t, name, cpu, fn)), f"phase 17 {name}: card != CPU"
    ev = s["ev"]
    cev = rpk.RingPackingEvaluator.from_keys(params, *(_move(getattr(ev, f), cpu)
                                                       for f in RING_PACKING_FIELDS[:4]))
    for f in RING_PACKING_FIELDS[4:]:
        assert _same(getattr(ev, f), getattr(cev, f)), f"phase 17 {f}: card != CPU"
    split = _timed(t, "split", cpu, lambda: cev.split(_move(s["ct_split"], cpu), hi.log_n))
    assert _same(s["split"], split), "phase 17 split: card != CPU"
    merge = _timed(t, "merge", cpu, lambda: cev.merge(*_move(s["split"], cpu), hi.log_n))
    assert _same(s["merge"], merge), "phase 17 merge: card != CPU"
    return t


def bridge_session(dev, times: dict, ci: dict) -> dict:
    """Phase 18 on ``dev``: the standard ring at logN 15 over phase 16's
    chain, its swap keys to phase 16's CI secret; complex_to_real of one
    ciphertext of 16384 reals, a CI mul_relin + rescale under phase 16's
    relinearization key, real_to_complex."""
    from matrix_fhe_tpu_torch.rlwe import decryptor, encryptor
    from matrix_fhe_tpu_torch.rlwe import keys as K
    from matrix_fhe_tpu_torch.schemes import ckks
    from matrix_fhe_tpu_torch.schemes.ckks import bridge
    cp = ci["params"]
    sk_ci, rlk_ci, _ = ci["keys"]
    std = ckks.new_parameters(ckks.CKKSParametersLiteral(
        logn=cp.log_n + 1, q=tuple(cp.q), p=tuple(cp.p),
        log_default_scale=cp.log_default_scale), device=dev)
    sk = _timed(times, "keygen secret (logN 15)", dev, lambda: K.gen_secret_key(_gen(601), std))
    s2c, c2s = _timed(times, "keygen ring-swap keys (standard <-> CI)", dev,
                      lambda: bridge.gen_ring_swap_keys_ci(_gen(602), std, sk, sk_ci))
    v = np.random.default_rng(SEED).uniform(-1, 1, std.max_slots)
    enc_std, enc_ci = ckks.Encoder(std), ckks.Encoder(cp)
    ct = _timed(times, "encode + encrypt (standard)", dev,
                lambda: encryptor.encrypt(_gen(603), std, sk, enc_std.encode(v + 0j)))
    ct_ci = _timed(times, "complex_to_real", dev, lambda: bridge.complex_to_real(std, ct, s2c))
    ev = ckks.Evaluator(cp, rlk=rlk_ci)
    sq = _timed(times, "CI mul_relin + rescale", dev,
                lambda: ev.rescale(ev.mul_relin(ct_ci, ct_ci)))
    back = _timed(times, "real_to_complex", dev, lambda: bridge.real_to_complex(std, sq, c2s))
    direct = bridge.real_to_complex(std, ct_ci, c2s)
    dec = _timed(times, "decrypt + decode x3", dev, lambda: {
        "switch": enc_ci.decode(decryptor.decrypt(cp, sk_ci, ct_ci)),
        "return": enc_std.decode(decryptor.decrypt(std, sk, direct)),
        "product": enc_std.decode(decryptor.decrypt(std, sk, back))})
    prec = {"switch": ckks.precision_stats(v, np.real(dec["switch"])),
            "return": ckks.precision_stats(v, np.real(dec["return"])),
            "product": ckks.precision_stats(v * v, np.real(dec["product"]))}
    return {"std": std, "keys": (sk, s2c, c2s), "ct": ct, "ct_ci": ct_ci, "sq": sq,
            "back": back, "direct": direct, "prec": prec}


def packed_boot_session(dev, times: dict, wide: dict) -> dict:
    """Phase 19 on ``dev``: on phase 12's keys and wide bootstrapper, the
    packed bootstrap of two ciphertexts of np.tile(v, 2) (its pack input
    and its expand outputs kept apart), and the sparse bootstrap of two
    logN-13 ciphertexts on the same chain through their ring-swap keys."""
    from matrix_fhe_tpu_torch.circuits.ckks import bootstrapping as btp
    from matrix_fhe_tpu_torch.rlwe import decryptor, encryptor
    from matrix_fhe_tpu_torch.rlwe import keys as K
    from matrix_fhe_tpu_torch.rlwe import ring_packing as rpk
    from matrix_fhe_tpu_torch.rlwe import ring_switch as rs
    from matrix_fhe_tpu_torch.schemes import ckks
    p, sk, evk, bts = wide["p"], wide["sk"], wide["evk"], wide["bts"]
    params = p.params
    level = p.residual_level
    extra = [g for g in btp.galois_elements_for_packed_bootstrap(params, 2) if g not in evk.gks]
    gks = _timed(times, f"keygen: {len(extra)} galois keys (pack, expand)", dev, lambda: {
        g: K.gen_galois_key(_gen(701 + i), params, sk, g) for i, g in enumerate(extra)})
    evk.gks.update(gks)   # the bootstrapper holds this dict (bts.gks)
    rng = np.random.default_rng(SEED)
    half = params.max_slots // 2
    va, vb = rng.uniform(-1, 1, half), rng.uniform(-1, 1, half)
    enc = ckks.Encoder(params)
    cts = _timed(times, "encode + encrypt x2 (tiled)", dev, lambda: [
        encryptor.encrypt(_gen(710 + i), params, sk, enc.encode(np.tile(v, 2), level=level))
        for i, v in enumerate((va, vb))])
    packed_in = _timed(times, "pack (2 -> 1)", dev, lambda: rpk.pack(
        params, {0: cts[0], 1: cts[1]}, input_log_gap=1, zero_garbage_slots=True, gks=bts.gks))
    boot = _timed(times, "bootstrap of the packed ciphertext", dev,
                  lambda: bts.bootstrap(packed_in))
    outs = _timed(times, "expand (1 -> 2)", dev, lambda: rpk.expand(
        params, boot, log_gap=0, gks=bts.gks, num_stages=1))
    packed = _timed(times, "bootstrap_packed x2", dev, lambda: bts.bootstrap_packed(cts))
    assert _same(packed, [outs[0], outs[1]]), "bootstrap_packed != pack, bootstrap, expand"
    small = ckks.new_parameters(ckks.CKKSParametersLiteral(
        logn=params.log_n - 1, q=tuple(params.q), p=tuple(params.p),
        log_default_scale=p.lit.log_default_scale), device=dev)
    sk_small = K.gen_secret_key(_gen(720), small)
    up, down = _timed(times, "keygen ring-swap keys 2^13 <-> 2^14", dev,
                      lambda: rs.gen_ring_swap_keys(_gen(721), small, params, sk_small, sk))
    ns = small.max_slots
    sa, sb = rng.uniform(-1, 1, ns), rng.uniform(-1, 1, ns)
    enc_small = ckks.Encoder(small)
    scts = _timed(times, "encode + encrypt x2 (logN 13)", dev, lambda: [
        encryptor.encrypt(_gen(730 + i), small, sk_small, enc_small.encode(v, level=level))
        for i, v in enumerate((sa, sb))])
    sparse = _timed(times, "bootstrap_sparse x2", dev,
                    lambda: bts.bootstrap_sparse(scts, small, up, down))
    dec = {"packed": [enc.decode(decryptor.decrypt(params, sk, o))[:half] for o in packed],
           "sparse": [enc_small.decode(decryptor.decrypt(small, sk_small, o))[:ns]
                      for o in sparse]}
    prec = {what: [ckks.precision_stats(w, np.real(d)) for w, d in zip(want, dec[what])]
            for what, want in (("packed", (va, vb)), ("sparse", (sa, sb)))}
    return {"gks": gks, "cts": cts, "packed_in": packed_in, "boot": boot, "outs": outs,
            "packed": packed, "small": small, "sk_small": sk_small, "swap": (up, down),
            "scts": scts, "sparse": sparse, "prec": prec}


def _bgv_model(v1, v2, diags) -> dict:
    """The slots each of phase 20's operations should hold, exactly mod T."""
    t = BGV_LITERAL["t"]
    a, b = v1.astype(object), v2.astype(object)
    half = len(v1) // 2
    vm = v1.reshape(2, half)
    lt = np.zeros_like(vm)
    for k, d in diags.items():
        lt = (lt + d.reshape(2, half) * np.roll(vm, -k, axis=1)) % t
    poly = np.zeros(len(v1), dtype=object)
    for c in reversed(BGV_POLY):
        poly = (poly * a + c) % t
    return {"add": (a + b) % t, "mul_relin + rescale (BGV)": (a * b) % t,
            "mul_relin (BFV)": (a * b) % t,
            "rotate_columns 1": np.concatenate([np.roll(v1[:half], -1), np.roll(v1[half:], -1)]),
            "rotate_rows": np.concatenate([v1[half:], v1[:half]]),
            f"lintrans {len(diags)} diagonals": lt.reshape(-1),
            "evaluate_polynomial_ps degree 7 (BFV)": poly}


def bgv_session(dev, times: dict, keys=None) -> dict:
    """Phase 20 on ``dev``: BGV / BFV at logN 14, T = 65537, keys from CPU
    generators (or ``keys``), the operations on two encrypted vectors of
    16384 slots, each decrypted and decoded."""
    from matrix_fhe_tpu_torch.circuits import bgv_circuits, lintrans as lt
    from matrix_fhe_tpu_torch.rlwe import decryptor, encryptor
    from matrix_fhe_tpu_torch.rlwe import keys as K
    from matrix_fhe_tpu_torch.schemes import bgv
    params = _timed(times, "parameters", dev, lambda: bgv.new_parameters(
        bgv.BGVParametersLiteral(**BGV_LITERAL), device=dev))
    t = params.t
    cols = params.n // 2
    ltp = lt.LinearTransformationParameters(
        diagonals_index_list=list(BGV_DIAGS), level_q=params.max_level,
        level_p=params.max_level_p, scale=1, log_dimensions=(1, params.log_n - 1),
        log_bsgs_ratio=0)
    gels = sorted({params.galois_element(1), params.galois_element_inverse()}
                  | set(lt.galois_elements(params, list(BGV_DIAGS), cols, 0)))
    if keys is None:
        def keygen():
            sk = K.gen_secret_key(_gen(801), params)
            return sk, K.gen_relinearization_key(_gen(802), params, sk), {
                g: K.gen_galois_key(_gen(810 + i), params, sk, g) for i, g in enumerate(gels)}
        keys = _timed(times, f"keygen (secret, relinearization, {len(gels)} galois)", dev,
                      keygen)
    else:
        keys = _move(keys, dev)
    sk, rlk, gks = keys
    rng = np.random.default_rng(SEED)
    v1, v2 = (rng.integers(0, t, params.n, dtype=np.int64) for _ in range(2))
    diags = {k: rng.integers(0, t, params.n, dtype=np.int64) for k in BGV_DIAGS}
    enc = bgv.Encoder(params)
    cts = _timed(times, "encode + encrypt x2", dev, lambda: [
        encryptor.encrypt(_gen(830 + i), params, sk, enc.encode(v))
        for i, v in enumerate((v1, v2))])
    ev = bgv.Evaluator(params, rlk=rlk, galois_keys=gks)
    evf = bgv.Evaluator(params, rlk=rlk, galois_keys=gks, scale_invariant=True)
    transform = _timed(times, "lintrans encode (4 diagonals)", dev,
                       lambda: bgv_circuits.new_linear_transformation(params, enc, diags, ltp))
    a, b = cts
    ops = {"add": lambda: ev.add(a, b),
           "mul_relin + rescale (BGV)": lambda: ev.rescale(ev.mul_relin(a, b)),
           "mul_relin (BFV)": lambda: evf.mul_relin(a, b),
           "rotate_columns 1": lambda: ev.rotate_columns(a, 1),
           "rotate_rows": lambda: ev.rotate_rows(a),
           f"lintrans {len(BGV_DIAGS)} diagonals": lambda: bgv_circuits.evaluate(
               params, a, transform, gks),
           "evaluate_polynomial_ps degree 7 (BFV)": lambda: bgv_circuits.evaluate_polynomial_ps(
               evf, enc, a, BGV_POLY)}
    outs = {name: _timed(times, name, dev, fn) for name, fn in ops.items()}
    dec = _timed(times, f"decrypt + decode x{len(outs)}", dev, lambda: {
        name: enc.decode(decryptor.decrypt(params, sk, ct)) for name, ct in outs.items()})
    return {"params": params, "keys": keys, "cts": cts, "outs": outs, "dec": dec,
            "model": _bgv_model(v1, v2, diags)}


def ring_phases(dev, smi: str, rng, int32_ops_per_s: float, clock: PhaseClock,
                refs: CPUReferences, wide: dict,
                ci: dict) -> dict:
    """Phases 17-20 (see the module's docstring); returns what the kernels
    line reports of B4 on these paths and B4's loss by shape over them."""
    from matrix_fhe_tpu_torch.circuits.ckks import bootstrapping as btp
    from matrix_fhe_tpu_torch.fast import fboot
    from matrix_fhe_tpu_torch.ops import ntt64_cuda
    from matrix_fhe_tpu_torch.rlwe import noise
    from matrix_fhe_tpu_torch.rlwe import ring_packing as rpk
    from matrix_fhe_tpu_torch.rlwe import ring_switch as rs
    from matrix_fhe_tpu_torch.schemes import ckks
    from matrix_fhe_tpu_torch.schemes.ckks import bridge
    cpu = torch.device("cpu")
    seen: dict = {}       # B4's calls by (direction, shape, moduli), phases 17-20
    launches: dict = {}   # and its launches there (cold passes), by phase
    ci_seen: dict = {}
    ci_launches: dict = {}
    counts: dict = {}

    def cold_warm(phase, fn, ci_ring=False):
        """fn(times) in a cold pass (B4's calls recorded and its launches
        counted, on the CI ring too with ``ci_ring``) and a warm one with the
        same seeds: (cold outputs, cold times, warm times, warm outputs)."""
        cold_t, warm_t = {}, {}

        def cold():
            def run():
                return b4_shapes(lambda: fn(cold_t), seen, launches.setdefault(phase, {}))
            return _shapes_in(ntt64_cuda, run, ci_seen, CI_ENTRIES, ci_launches) \
                if ci_ring else run()

        out, counts[phase] = _b4_counted(dev, cold)
        return out, cold_t, warm_t, fn(warm_t)

    def report(tag, cold_t, warm_t):
        for name, ms in cold_t.items():
            print(f"phase {tag}: {name:48s} cold {ms:10.3f} ms, warm {warm_t[name]:10.3f} ms"
                  f" | {smi}")

    # -- 17. ring switching and packing at logN 12-14 ------------------------------------
    s, cold_t, warm_t, warm = cold_warm("17", lambda t: ring_switch_session(dev, t))
    for k in ("keys", "up", "down", "expand", "pack", "split", "merge",
              *(f"{w} {n}" for n in RS_PAIRINGS for w in ("extract", "repack"))):
        assert _same(s[k], warm[k]), f"phase 17 {k}: warm pass != cold pass"
    del warm
    hi = s["params"][RS_LOGNS[-1]]
    print(f"phase ring switch: PN14QP438's chain ({len(hi.q)} + {len(hi.p)} primes of "
          f"{min(q.bit_length() for q in hi.q + hi.p)}-{max(q.bit_length() for q in hi.q + hi.p)}"
          f" bits) at logN {RS_LOGNS}; {len(s['keys'][4])} galois keys at logN 14, the "
          f"RingPackingEvaluator's {len(s['ev'].gks_min)} at logN 12")
    report("ring switch", cold_t, warm_t)
    err = check_ring_switch(s)
    for what, e in err.items():
        print(f"phase ring switch: {what:16s} max |error| {e:.3e} (bound "
              f"{RS_BOUNDS[what.split()[0]]})")
    sk_lo, sk_hi, up, down, _ = s["keys"]
    lo = s["params"][RS_LOGNS[-1] - 1]
    emb = rs.embed_secret_key(lo, hi, sk_lo)
    key_noise = {"up": noise.noise_evaluation_key(hi, up.gadget, emb.value.q, sk_hi),
                 "down": noise.noise_evaluation_key(hi, down.gadget, sk_hi.value.q, emb)}
    print(f"phase ring switch: key noise (log2 std, rlwe/noise.py) evk_up "
          f"{key_noise['up']:.4f} bits, evk_down {key_noise['down']:.4f} bits")
    # held to the same calls on the CPU (a worker process) after phase 25
    ev = s["ev"]
    refs.submit("ring switch", {
        **{k: s[k] for k in RING_SWITCH_INPUTS},
        "ev": types.SimpleNamespace(**_move({f: getattr(ev, f) for f in RING_PACKING_FIELDS},
                                            "cpu"))})
    print(f"phase ring switch: B4 launches {counts['17']}")
    del s

    clock.done(17)

    # -- 18. the bridge, standard logN 15 <-> CI logN 14 ---------------------------------
    b, cold_t, warm_t, warm = cold_warm("18", lambda t: bridge_session(dev, t, ci), ci_ring=True)
    for k in ("keys", "ct", "ct_ci", "sq", "back"):
        assert _same(b[k], warm[k]), f"phase 18 {k}: warm pass != cold pass"
    del warm
    print(f"phase bridge: standard logN {b['std'].log_n} ({b['std'].max_slots} slots) <-> CI "
          f"logN {ci['params'].log_n} over phase 16's chain and CI keys")
    report("bridge", cold_t, warm_t)
    for what, st in b["prec"].items():
        floor = BRIDGE_FLOOR[what]
        print(f"phase bridge: precision after {what:8s} mean {st.avg_precision:.4f} bits, min "
              f"{st.min_precision:.4f} bits (floor {floor}: tests/test_bridge.py) | {smi}")
        assert st.min_precision >= floor, f"bridge {what}: below the floor"
    cstd = ckks.new_parameters(ckks.CKKSParametersLiteral(
        logn=b["std"].log_n, q=tuple(b["std"].q), p=tuple(b["std"].p),
        log_default_scale=b["std"].log_default_scale), device=cpu)
    _, s2c, c2s = _move(b["keys"], cpu)
    assert _same(b["ct_ci"], bridge.complex_to_real(cstd, _move(b["ct"], cpu), s2c)), \
        "bridge complex_to_real: card != CPU"
    assert _same(b["back"], bridge.real_to_complex(cstd, _move(b["sq"], cpu), c2s)), \
        "bridge real_to_complex: card != CPU"
    print(f"phase bridge: card == CPU (the card's inputs and keys, the plain NTT) for "
          f"complex_to_real and real_to_complex; B4 launches (standard ring) {counts['18']}, "
          f"on the CI ring {sum(ci_launches.values())}")
    del b

    clock.done(18)

    # -- 19. the packed and sparse bootstrap at logN 14 ----------------------------------
    pb, cold_t, warm_t, warm = cold_warm("19", lambda t: packed_boot_session(dev, t, wide))
    for k in ("cts", "packed_in", "boot", "packed", "scts", "sparse"):
        assert _same(pb[k], warm[k]), f"phase 19 {k}: warm pass != cold pass"
    del warm
    wp = wide["p"]
    els = btp.galois_elements_for_packed_bootstrap(wp.params, 2)
    print(f"phase packed boot: phase 12's wide_parameters_literal({LOGN}) keys and "
          f"bootstrapper (sparse secret weight {wp.lit.ephemeral_secret_weight}, residual level "
          f"{wp.residual_level}); galois_elements_for_packed_bootstrap(params, 2) = {els}: "
          f"{len(els) - len(pb['gks'])} already in the bootstrap's key set, "
          f"{len(pb['gks'])} added")
    report("packed boot", cold_t, warm_t)
    for what, sts in pb["prec"].items():
        floor = PACKED_FLOOR[what]
        for i, st in enumerate(sts):
            out = pb[what][i]
            print(f"phase packed boot: {what} output {i}: mean {st.avg_precision:.4f} bits, min "
                  f"{st.min_precision:.4f} bits (floor: min above {floor}, "
                  f"tests/test_boot_packed.py), level {out.level} | {smi}")
            assert out.level == wp.residual_level
            assert st.min_precision > floor, f"{what} bootstrap: below the floor"
    cparams = btp.Parameters(fboot.wide_parameters_literal(LOGN), device=cpu).params
    cgks = _move({g: wide["evk"].gks[g] for g in btp.galois_elements_for_packed_bootstrap(
        cparams, 2)}, cpu)
    assert _same(pb["packed_in"], rpk.pack(cparams, _move({0: pb["cts"][0], 1: pb["cts"][1]}, cpu),
                                           input_log_gap=1, zero_garbage_slots=True, gks=cgks)), \
        "phase 19 pack: card != CPU"
    assert _same(pb["outs"], rpk.expand(cparams, _move(pb["boot"], cpu), log_gap=0, gks=cgks,
                                        num_stages=1)), "phase 19 expand: card != CPU"
    csmall = ckks.new_parameters(ckks.CKKSParametersLiteral(
        logn=LOGN - 1, q=tuple(cparams.q), p=tuple(cparams.p),
        log_default_scale=wp.lit.log_default_scale), device=cpu)
    cup, _ = _move(pb["swap"], cpu)
    assert _same(rs.switch_up(csmall, cparams, _move(pb["scts"][0], cpu), cup),
                 rs.switch_up(pb["small"], wp.params, pb["scts"][0], pb["swap"][0])), \
        "phase 19 switch_up: card != CPU"
    print(f"phase packed boot: card == CPU (the card's inputs and keys, the plain NTT) for the "
          f"pack into the bootstrap, the expand out of it and a switch_up; bootstrap_packed == "
          f"pack, bootstrap, expand; B4 launches {counts['19']}")
    evk = wide["evk"]
    for g in pb["gks"]:
        del evk.gks[g]
    del pb

    clock.done(19)

    # -- 20. BGV and BFV at logN 14, T = 65537 ---------------------------------------------
    bg, cold_t, warm_t, warm = cold_warm("20", lambda t: bgv_session(dev, t))
    for k in ("keys", "cts", "outs", "dec"):
        assert _same(bg[k], warm[k]), f"phase 20 {k}: warm pass != cold pass"
    del warm
    bp = bg["params"]
    print(f"phase bgv: logN {bp.log_n}, T = {bp.t} ({bp.n_t} slots), Q "
          f"{[q.bit_length() for q in bp.q]} bits, P {[p.bit_length() for p in bp.p]} bits, "
          f"QMul {[q.bit_length() for q in bp.ring_qmul.moduli_tuple]} bits")
    report("bgv", cold_t, warm_t)
    for name, got in bg["dec"].items():
        ok = np.array_equal(np.asarray(got).astype(object) % bp.t, bg["model"][name] % bp.t)
        print(f"phase bgv: {name:40s} level out {bg['outs'][name].level}, decoded == numpy mod T:"
              f" {ok}")
        assert ok, f"phase 20 {name}: decoded != numpy mod T"
    rlk_noise = noise.noise_relinearization_key(bp, bg["keys"][1], bg["keys"][0])
    print(f"phase bgv: relinearization key noise (log2 std, rlwe/noise.py) {rlk_noise:.4f} bits")
    to_hold = {"bgv": _held(bg, "bgv")}
    print(f"phase bgv: B4 launches {counts['20']}")
    del bg

    clock.done(20)

    # -- B4 at every shape phases 17-20 gave it ---------------------------------------------
    shape_rows = check_b4_shapes(seen, dev, rng)
    for d, shape, c, err_, _ in shape_rows:
        assert err_ == 0, f"B4 {d} {shape}: kernel != plain ({err_})"
    ns = sorted({shape[-1] for _, shape, *_ in shape_rows})
    print(f"phase b4: B4 at the {len(shape_rows)} shapes (direction, shape, moduli) of phases "
          f"17-20, N = {ns}: kernel == plain at every one")
    ci_rows = check_ci_shapes(ci_seen, dev, rng)
    for d, shape, err_, _, names, _ in ci_rows:
        assert err_ == 0, f"B4 on the CI ring {d} {shape}: kernel != plain ({err_})"
        assert len(names) == 3 and all("ntt64" in k for k in names), (d, shape, names)
    print(f"phase b4: B4 on the CI ring at the {len(ci_rows)} shapes of phase 18: kernel == "
          f"plain, one kernel a call")
    loss = [row for phase, counted in launches.items() for row in b4_loss(
        seen, counted, dev, rng, int32_ops_per_s, smi, f"phase {phase}, {PHASE_NAMES[phase]}")]
    ci_loss = b4_loss(ci_seen, ci_launches, dev, rng, int32_ops_per_s, smi,
                      "phase 18, CI ring", ci=True)
    return {"shape_rows": shape_rows, "ci_rows": ci_rows, "loss": loss, "ci_loss": ci_loss,
            "to_hold": to_hold,
            "by_path": {f"{PHASE_NAMES[k]} (phase {k})": v for k, v in counts.items()},
            "ci_launches": {d: sum(n for (dd, *_), n in ci_launches.items() if dd == d)
                            for d in ("fwd", "bwd")}}


# -- phases 21-22: RGSW and blind rotation, the multiparty protocols ------------------------

def _pn14_params(device, logp=True):
    """A CKKS parameter set on PN14QP438's chain at logN 14, scale 2^45 (with
    its two P primes, or P-less)."""
    from matrix_fhe_tpu_torch.fast import wckks
    from matrix_fhe_tpu_torch.schemes import ckks
    return ckks.new_parameters(ckks.CKKSParametersLiteral(
        logn=LOGN, q=wckks.PN14QP438_Q, p=wckks.PN14QP438_P if logp else (),
        log_default_scale=SESSION_LOG_SCALE), device=device)


def rgsw_session(dev, times: dict) -> dict:
    """Phase 21 (a) on ``dev``: RGSW(3) and RGSW(X^5) with the standard
    gadget and RGSW(3) with a P-less base-two gadget (B = 12) on the same Q,
    each times a fresh encryption of 8192 real slots; decrypted and decoded."""
    from matrix_fhe_tpu_torch.ops import automorphism as am
    from matrix_fhe_tpu_torch.rgsw import rgsw
    from matrix_fhe_tpu_torch.rlwe import decryptor, encryptor
    from matrix_fhe_tpu_torch.rlwe import keys as K
    from matrix_fhe_tpu_torch.rlwe.elements import Plaintext
    from matrix_fhe_tpu_torch.schemes import ckks
    params, pless = _pn14_params(dev), _pn14_params(dev, logp=False)
    rng = np.random.default_rng(SEED)
    v = {k: rng.uniform(-1, 1, params.max_slots) + 0j for k in RGSW_BOUNDS}
    enc, enc2 = ckks.Encoder(params), ckks.Encoder(pless)
    sk = _timed(times, "keygen secret x2", dev, lambda: (
        K.gen_secret_key(_gen(2101), params), K.gen_secret_key(_gen(2102), pless)))
    cts = _timed(times, "encode + encrypt x3", dev, lambda: {
        "scalar": encryptor.encrypt(_gen(2103), params, sk[0], enc.encode(v["scalar"])),
        "monomial": encryptor.encrypt(_gen(2104), params, sk[0], enc.encode(v["monomial"])),
        "base2": encryptor.encrypt(_gen(2105), pless, sk[1], enc2.encode(v["base2"]))})
    rq = params.ring_q
    mono = torch.zeros((len(params.q), params.n), dtype=torch.int64, device=dev)
    mono[:, RGSW_MONOMIAL] = 1
    b2 = K.EvaluationKeyParameters(level_p=-1, base_two_decomposition=RGSW_BASE_TWO)
    rg = {"scalar": _timed(times, "RGSW(3) encrypt", dev, lambda: rgsw.encrypt_plaintext(
              _gen(2106), params, sk[0], 3)),
          "monomial": _timed(times, f"RGSW(X^{RGSW_MONOMIAL}) encrypt", dev, lambda: rgsw.encrypt(
              _gen(2107), params, sk[0], rq.mform(rq.ntt(mono)))),
          "base2": _timed(times, f"RGSW(3) base-two B={RGSW_BASE_TWO} encrypt", dev,
                          lambda: rgsw.encrypt_plaintext(_gen(2108), pless, sk[1], 3, b2))}
    # each case's (parameters, encoder, secret)
    case = {"scalar": (params, enc, sk[0]), "monomial": (params, enc, sk[0]),
            "base2": (pless, enc2, sk[1])}
    outs = {k: _timed(times, f"external product {k}", dev, lambda k=k: rgsw.external_product(
        case[k][0], cts[k], rg[k])) for k in RGSW_BOUNDS}
    dec = _timed(times, "decrypt + decode x3", dev, lambda: {
        k: e.decode(decryptor.decrypt(p, key, outs[k])) for k, (p, e, key) in case.items()})
    ptd = decryptor.decrypt(params, sk[0], cts["monomial"])
    shifted = am.mult_by_monomial(rq, rq.intt(ptd.value), RGSW_MONOMIAL)
    want = {"scalar": 3 * v["scalar"], "base2": 3 * v["base2"],
            "monomial": enc.decode(Plaintext(value=rq.ntt(shifted), metadata=ptd.metadata))}
    return {"params": params, "sk": sk, "cts": cts, "rg": rg, "outs": outs, "dec": dec,
            "want": want}


def _blindrot_params(device):
    """Phase 21 (b)'s rings: the blind rotation's at logN 10 (a 27-bit Q and a
    31-bit P prime, drawn as tests/test_blindrot.py draws them), the LWE
    ring at logN 9 (a 14-bit prime, the default ternary secret)."""
    from matrix_fhe_tpu_torch import rlwe
    from matrix_fhe_tpu_torch.utils import primes as pr
    (logn, qb, pb), (logn_lwe, qb_lwe) = BR_RING, BR_LWE

    def prime(bits, logn_):
        return tuple(pr.NTTFriendlyPrimesGenerator(bits, 2 << logn_).next_alternating_primes(1))
    return (rlwe.new_parameters(rlwe.ParametersLiteral(logn=logn, q=prime(qb, logn),
                                                       p=prime(pb, logn)), device),
            rlwe.new_parameters(rlwe.ParametersLiteral(logn=logn_lwe, q=prime(qb_lwe, logn_lwe)),
                                device))


def _sign(x: float) -> float:
    return 1.0 if x > 0 else (-1.0 if x < 0 else 0.0)


def blindrot_session(dev, times: dict) -> dict:
    """Phase 21 (b) on ``dev``: the keys (gen_evaluation_key in its two parts,
    the draws and the deterministic part), the sign test polynomial, an
    LWE encryption of BR_VALUES at scale q / 4 in its first coefficients,
    evaluate over the 4 slots, and each slot decrypted."""
    from matrix_fhe_tpu_torch.ops import ntt64_cuda
    from matrix_fhe_tpu_torch.rgsw import blindrot
    from matrix_fhe_tpu_torch.rlwe import decryptor, encryptor
    from matrix_fhe_tpu_torch.rlwe import keys as K
    from matrix_fhe_tpu_torch.rlwe.elements import MetaData, Plaintext
    from matrix_fhe_tpu_torch.schemes.ckks.encoder import crt_reconstruct_centered
    pb, pl = _blindrot_params(dev)
    sk_br, sk_lwe = _timed(times, "keygen secrets", dev, lambda: (
        K.gen_secret_key(_gen(2111), pb), K.gen_secret_key(_gen(2112), pl)))
    samples = _timed(times, f"gen_evaluation_key draws ({pl.n} RGSW + "
                     f"{len(blindrot.galois_elements(pb))} galois)", dev,
                     lambda: blindrot.sample_evaluation_key(_gen(2113), pb, pl))
    brk = _timed(times, "gen_evaluation_key deterministic part", dev,
                 lambda: blindrot.evaluation_key_from_samples(pb, sk_br, pl, sk_lwe, samples))
    del samples
    scale_br = pb.q[0] / 4.0
    test_poly = _timed(times, "init_test_polynomial", dev, lambda: blindrot.init_test_polynomial(
        _sign, scale_br, pb, -1, 1))
    coeffs = np.zeros((1, pl.n), dtype=np.int64)
    for i, x in enumerate(BR_VALUES):
        c = int(round(abs(x) * pl.q[0] / 4.0))
        coeffs[0, i] = (pl.q[0] - c) % pl.q[0] if x < 0 else c
    ct = _timed(times, "LWE encrypt", dev, lambda: encryptor.encrypt(
        _gen(2114), pl, sk_lwe, Plaintext(value=pl.ring_q.ntt(torch.from_numpy(coeffs).to(dev)),
                                          metadata=MetaData(is_ntt=True))))
    ev = blindrot.Evaluator(pb, pl)
    slots = range(len(BR_VALUES))
    out, launches = _launched(ntt64_cuda, lambda: _timed(
        times, f"evaluate, {len(BR_VALUES)} slots", dev, lambda: ev.evaluate(
            ct, {i: test_poly for i in slots}, brk)))

    def decrypt(i):
        c = pb.ring_q.intt(decryptor.decrypt(pb, sk_br, out[i]).value)
        return float(crt_reconstruct_centered(c.cpu().numpy(), pb.q)[0]) / scale_br
    got = _timed(times, "decrypt x4", dev, lambda: [decrypt(i) for i in slots])
    _, masks = ev.lwe_samples(ct, list(slots))
    steps = [ev.schedule(masks[i]) for i in slots]
    return {"params": (pb, pl), "keys": (sk_br, sk_lwe, brk), "test_poly": test_poly, "ct": ct,
            "out": out, "got": got, "launches": launches,
            "steps": [{k: sum(s[0] == k for s in st) for k in ("product", "auto")}
                      for st in steps]}


def _ideal_secret(params, sks):
    from matrix_fhe_tpu_torch.rlwe import keys as K
    rq, rp = params.ring_q, params.ring_p
    q, p = sks[0].value.q, sks[0].value.p
    for s in sks[1:]:
        q, p = rq.add(q, s.value.q), rp.add(p, s.value.p)
    return K.SecretKey(value=K.QPPoly(q=q, p=p))


def _aggregate(agg, params, shares):
    out = shares[0]
    for s in shares[1:]:
        out = agg(params, out, s)
    return out


def multiparty_session(dev, times: dict) -> dict:
    """Phase 22 on ``dev``: tests/test_multiparty.py's protocols among 3
    parties at logN 14 (PN14QP438's chain for CKKS, phase 20's for BGV), each
    finalized and decrypted; every party draws from its own CPU generator,
    the common reference strings from theirs."""
    from matrix_fhe_tpu_torch import multiparty as mp
    from matrix_fhe_tpu_torch.multiparty import mpbgv, mpckks
    from matrix_fhe_tpu_torch.rlwe import decryptor, encryptor
    from matrix_fhe_tpu_torch.rlwe import evaluator as rlwe_eval
    from matrix_fhe_tpu_torch.rlwe import keys as K
    from matrix_fhe_tpu_torch.schemes import bgv, ckks
    params = _pn14_params(dev)
    enc = ckks.Encoder(params)
    n_p = range(MP_PARTIES)
    rng = np.random.default_rng(SEED)
    # complex slots, real ones where tests/test_multiparty.py draws real ones
    v = {k: rng.uniform(-1, 1, params.max_slots) + 1j * (
        0 if k in ("relinearization key", "key switch") else rng.uniform(-1, 1, params.max_slots))
        for k in MP_BOUNDS if k != "public key switch"}
    sks = _timed(times, "keygen secrets x3 (+3 out)", dev, lambda: [
        K.gen_secret_key(_gen(2201 + i), params) for i in range(2 * MP_PARTIES)])
    sks, sk_outs = sks[:MP_PARTIES], sks[MP_PARTIES:]
    ideal, ideal_out = _ideal_secret(params, sks), _ideal_secret(params, sk_outs)
    out, dec = {}, {}

    def run(name, fn):
        out[name] = _timed(times, name, dev, fn)

    def cpk(site):
        crp = mp.PublicKeyGen.sample_crp(_gen(site), params)
        shares = [mp.PublicKeyGen.gen_share(_gen(site + 1 + i), params, sks[i], crp) for i in n_p]
        pk = mp.PublicKeyGen.finalize(params, _aggregate(mp.PublicKeyGen.aggregate, params,
                                                         shares), crp)
        return shares, pk

    def encrypt(site, key, vals, level=None):
        return encryptor.encrypt(_gen(site), params, key, enc.encode(vals, level=level))

    run("public key", lambda: cpk(2210))
    cts = {"public key": encrypt(2215, out["public key"][1], v["public key"])}
    gal_el = params.galois_element(1)

    def galois():
        crp = mp.GaloisKeyGen.sample_crp(_gen(2220), params)
        shares = [mp.GaloisKeyGen.gen_share(_gen(2221 + i), params, sks[i], gal_el, crp)
                  for i in n_p]
        return shares, mp.GaloisKeyGen.finalize(
            params, _aggregate(mp.GaloisKeyGen.aggregate, params, shares), crp, gal_el)
    run("galois key", galois)
    cts["galois key"] = encrypt(2225, ideal, v["galois key"])
    cts["galois key rotated"] = rlwe_eval.automorphism(params, cts["galois key"],
                                                       out["galois key"][1])

    def relin():
        crp = mp.RelinKeyGen.sample_crp(_gen(2230), params)
        r1 = [mp.RelinKeyGen.gen_share_round1(_gen(2231 + i), params, sks[i], crp) for i in n_p]
        agg1 = _aggregate(mp.RelinKeyGen.aggregate_round1, params, [s for _, s in r1])
        r2 = [mp.RelinKeyGen.gen_share_round2(_gen(2235 + i), params, r1[i][0], sks[i], agg1)
              for i in n_p]
        return r1, r2, mp.RelinKeyGen.finalize(
            params, agg1, _aggregate(mp.RelinKeyGen.aggregate_round2, params, r2))
    run("relinearization key", relin)
    ev = ckks.Evaluator(params, rlk=out["relinearization key"][2])
    cts["relinearization key"] = encrypt(2239, ideal, v["relinearization key"])
    cts["relinearization key product"] = ev.rescale(ev.mul_relin(
        cts["relinearization key"], cts["relinearization key"]))
    ct = cts["key switch"] = encrypt(2240, ideal, v["key switch"])
    run("key switch", lambda: mp.KeySwitch.finalize(params, ct, _aggregate(
        mp.KeySwitch.aggregate, params, [mp.KeySwitch.gen_share(_gen(2245 + i), params, sks[i],
                                                                sk_outs[i], ct) for i in n_p])))
    pk_out = cpk(2250)[1]
    run("public key switch", lambda: mp.PublicKeySwitch.finalize(params, ct, _aggregate(
        mp.PublicKeySwitch.aggregate, params, [mp.PublicKeySwitch.gen_share(
            _gen(2255 + i), params, sks[i], pk_out, ct) for i in n_p])))

    def threshold():
        received = {p: [] for p in MP_POINTS}
        for i in n_p:
            spoly = mp.Thresholdizer.gen_shamir_polynomial(_gen(2260 + i), params,
                                                           MP_THRESHOLD, sks[i])
            for p in MP_POINTS:
                received[p].append(mp.Thresholdizer.gen_shamir_secret_share(params, p, spoly))
        own = {p: _aggregate(mp.Thresholdizer.aggregate, params, received[p])
               for p in MP_POINTS}
        return [mp.Combiner(params, p, MP_POINTS, MP_THRESHOLD).gen_additive_share(
            MP_ACTIVES, own[p]) for p in MP_ACTIVES]
    run("threshold 2-of-3", threshold)

    def refresh(name, site, seed0, transform=None):
        ct = cts[name] = encrypt(site, ideal, v[name], level=0)
        crs_poly = mpckks.MaskedTransform.sample_crp(_gen(site + 1), params, params.max_level)
        shares = [mpckks.MaskedTransform.gen_share(
            _gen(site + 2 + i), seed0 + i, params, sks[i], sks[i], MP_LOG_BOUND, ct, crs_poly,
            params.default_scale, transform=transform) for i in n_p]
        agg = _aggregate(mpckks.MaskedTransform.aggregate, params, shares)
        return shares, mpckks.MaskedTransform.transform(params, ct, crs_poly, agg,
                                                        params.default_scale, transform=transform)
    run("refresh", lambda: refresh("refresh", 2270, 9000))
    run("refresh with transform", lambda: refresh("refresh with transform", 2280, 9900,
                                                  lambda z: -z))
    bparams = bgv.new_parameters(bgv.BGVParametersLiteral(**BGV_LITERAL), device=dev)
    benc = bgv.Encoder(bparams)
    bsks = [K.gen_secret_key(_gen(2290 + i), bparams) for i in n_p]
    bideal = _ideal_secret(bparams, bsks)
    bv = rng.integers(0, bparams.t, bparams.n, dtype=np.int64)
    bct = encryptor.encrypt(_gen(2294), bparams, bideal, benc.encode(bv, level=0))

    def bgv_refresh():
        crs_poly = mpbgv.Refresh.sample_crp(_gen(2295), bparams, bparams.max_level)
        shares = [mpbgv.Refresh.gen_share(_gen(2296 + i), bparams, bsks[i], bct, crs_poly)
                  for i in n_p]
        return shares, mpbgv.Refresh.finalize(bparams, bct, _aggregate(
            mpbgv.Refresh.aggregate, bparams, shares), crs_poly)
    run("BGV refresh", bgv_refresh)

    def decode(sk, ct):
        return enc.decode(decryptor.decrypt(params, sk, ct))
    dec = _timed(times, "decrypt + decode x7", dev, lambda: {
        "public key": decode(ideal, cts["public key"]),
        "galois key": decode(ideal, cts["galois key rotated"]),
        "relinearization key": decode(ideal, cts["relinearization key product"]),
        "key switch": decode(ideal_out, out["key switch"]),
        "public key switch": decode(ideal, out["public key switch"]),
        "refresh": decode(ideal, out["refresh"][1]),
        "refresh with transform": decode(ideal, out["refresh with transform"][1]),
        "BGV refresh": benc.decode(decryptor.decrypt(bparams, bideal, out["BGV refresh"][1]))})
    want = {**v, "galois key": np.roll(v["galois key"], -1),
            "relinearization key": v["relinearization key"] ** 2,
            "public key switch": v["key switch"],
            "refresh with transform": -v["refresh with transform"]}
    return {"params": params, "bparams": bparams, "keys": (sks, sk_outs, bsks), "ideal": ideal,
            "cts": cts, "bct": bct, "out": out, "dec": dec, "want": want, "bv": bv}


def _python_int_timers():
    """Wrap the multiparty modules' Python-integer parts (the masks, the CRT
    to and from positional integers, the transform and scaling of the masked
    values, the Lagrange coefficients) to sum their host time, in ms; returns
    (the sums, a function that unwraps them)."""
    from matrix_fhe_tpu_torch.multiparty import mpckks, threshold
    sums: dict = {}
    saved = []

    def wrap(owner, name, label):
        fn = getattr(owner, name)

        def timed(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                sums[label] = sums.get(label, 0.0) + (time.perf_counter() - t0) * 1e3
        saved.append((owner, name, fn))
        setattr(owner, name, timed)
    wrap(mpckks, "sample_mask", "sample_mask")
    wrap(mpckks, "poly_to_bigint_centered", "poly_to_bigint_centered")
    wrap(mpckks, "set_coefficients_bigint", "set_coefficients_bigint (with its move and NTT)")
    wrap(mpckks, "_apply_transform_and_scale", "transform and scale of the masked values")
    wrap(threshold.Combiner, "__init__", "Combiner: Lagrange coefficients")

    def restore():
        for owner, name, fn in saved:
            setattr(owner, name, fn)
    return sums, restore


def _held(out: dict, name: str) -> dict:
    """What the card's session ``out`` is held to reference ``name`` by: its
    keys as their digest and the outputs ``CPU_REFERENCES`` names."""
    return {"keys": _tree_digest(out["keys"]),
            **{k: out[k] for k in CPU_REFERENCES[name] if k != "keys"}}


def boot_reference(dev, times: dict) -> dict:
    """Phase 9's cold pass from its seeds on ``dev``: the keys (as their
    digest), the input, bootstrap, evaluate(iterations=2) and both decodings."""
    from matrix_fhe_tpu_torch.circuits.ckks import bootstrapping as btp
    from matrix_fhe_tpu_torch.fast import fboot
    bp = btp.Parameters(fboot.FAST_N14, device=dev)
    sk, evk = boot_keys(bp, times)
    return {"keys": _tree_digest((sk, evk)), **boot_session(bp, sk, evk, times)}


def wide_boot_reference(dev, times: dict) -> dict:
    """Phase 12's cold pass from its seeds on ``dev``: the keys (as their
    digest), the input, the bootstrap and its decoding."""
    from matrix_fhe_tpu_torch.circuits.ckks import bootstrapping as btp
    from matrix_fhe_tpu_torch.fast import fboot
    wp = btp.Parameters(fboot.wide_parameters_literal(LOGN), device=dev)
    sk, evk = boot_keys(wp, times)
    return {"keys": _tree_digest((sk, evk)), **wide_boot_session(wp, sk, evk, times)}


def _keys_digested(session, **kw):
    """``session`` (a phase's session function) as a reference: its keys
    returned as their digest."""
    def reference(dev, times: dict) -> dict:
        out = session(dev, times, **kw)
        return {**out, "keys": _tree_digest(out["keys"])}
    return reference


# phase 13's circuits, in two references of about equal time
CIRCUIT_HALVES = (("sign", "step", "max"),
                  ("min", "goldschmidt_division", "evaluate_positive_domain"))
# each CPU reference session and the outputs the card's are held to, in the
# order the worker processes take them: the longest, then phases 21-25's
# (read in their phases, before the others), then the rest longest first
CPU_REFERENCES = {"wide boot": ("keys", "ct", "boot", "dec"),
                  "blindrot": ("keys", "test_poly", "ct", "out", "got"),
                  "rgsw": ("sk", "cts", "rg", "outs", "dec"),
                  "multiparty": ("keys", "cts", "bct", "out", "dec"),
                  "flagship": ("out", "dec", "blobs"), "examples": ("outs",),
                  "circuits 2": ("keys", "out"), "circuits 1": ("keys", "out"),
                  "boot": ("keys", "ct", "boot", "meta", "dec", "dec_meta"),
                  "matrix": ("keys", "cts", "outs", "dec"), "wide step": ("outs",),
                  "bgv": ("keys", "cts", "outs", "dec"), "ci": ("keys", "cts", "outs", "dec")}
# the references that take the card's inputs (``CPUReferences.submit``)
SHIPPED_REFERENCES = {"ring switch": ()}
# phases 9, 11-13, 15, 16 and 20, held to their references after phase 25:
# (phase, the tag of its lines, its references)
HELD_PHASES = ((9, "boot", ("boot",)), (11, "wide step", ("wide step",)),
               (12, "wide boot", ("wide boot",)), (13, "circuits", ("circuits 1", "circuits 2")),
               (15, "matrix", ("matrix",)), (16, "ci", ("ci",)), (20, "bgv", ("bgv",)))
# the torch threads of a worker process and of the main process while
# they run: on an 8-core host 3 workers x 2 + 2 threads keep the cores busy
# and not oversubscribed (the card's phases drive the card from one host
# thread; an idle torch thread pool spins on the cores it holds)
CPU_WORKER_THREADS, MAIN_THREADS, MAX_CPU_WORKERS = 2, 2, 3


def ring_switch_reference(dev, times: dict, s: dict) -> dict:
    """Phase 17's switches, expand / pack and split / merge on ``dev`` from
    the card's inputs and keys ``s`` (``ring_switch_cpu`` holds each to the
    card's output)."""
    times.update(ring_switch_cpu(s))
    return {}


def _cpu_reference(name: str, inputs: bytes = b"") -> bytes:
    """Session ``name`` (of phases 9, 11-13, 15-17 and 20-25) on the CPU
    (the same calls, the same generator seeds as on the card; phase 17's
    on the card's inputs, pickled in ``inputs``), pickled with its times
    (ms by stage) and its time in s.  It runs in a worker process beside
    the card's phases and is read when its phase compares."""
    torch.set_num_threads(CPU_WORKER_THREADS)  # the other cores stay with the card's phases
    fn = {"wide boot": wide_boot_reference, "boot": boot_reference,
          "circuits 1": _keys_digested(wide_circuits, names=CIRCUIT_HALVES[0]),
          "circuits 2": _keys_digested(wide_circuits, names=CIRCUIT_HALVES[1]),
          "rgsw": rgsw_session, "blindrot": blindrot_session,
          "multiparty": multiparty_session, "wide step": wide_step_reference,
          "matrix": _keys_digested(matrix_session), "ci": _keys_digested(ci_session),
          "bgv": _keys_digested(bgv_session), "ring switch": ring_switch_reference,
          "flagship": flagship_reference, "examples": examples_reference}[name]
    times: dict = {}
    t0 = time.perf_counter()
    out = fn(torch.device("cpu"), times, *([pickle.loads(inputs)] if inputs else []))
    what = {**CPU_REFERENCES, **SHIPPED_REFERENCES}[name]
    return pickle.dumps({**{k: out[k] for k in what}, "times": times,
                         "seconds": time.perf_counter() - t0})


class CPUReferences:
    """The CPU references in a pool of spawned worker processes, one for
    each two cores this process may use beyond ``MAIN_THREADS`` (at most
    ``MAX_CPU_WORKERS``, at least one).  Those made from seeds
    (``CPU_REFERENCES``) start at once; ``submit`` adds one that takes the
    card's inputs; ``get`` waits for one and unpickles it."""

    def __init__(self):
        import os
        cores = len(os.sched_getaffinity(0))
        self.workers = max(1, min(MAX_CPU_WORKERS,
                                  (cores - MAIN_THREADS) // CPU_WORKER_THREADS))
        self.pool = multiprocessing.get_context("spawn").Pool(self.workers)
        self.pending = {name: self.pool.apply_async(_cpu_reference, (name,))
                        for name in CPU_REFERENCES}

    def submit(self, name: str, inputs) -> None:
        """Reference ``name`` on ``inputs`` (moved to the CPU and pickled)."""
        self.pending[name] = self.pool.apply_async(
            _cpu_reference, (name, pickle.dumps(_move(inputs, "cpu"))))

    def get(self, name: str) -> dict:
        return pickle.loads(self.pending[name].get())

    def close(self) -> None:
        self.pool.terminate()
        self.pool.join()


def hold_to_cpu_references(to_hold: dict, refs: CPUReferences, clock: PhaseClock) -> None:
    """The outputs on the card of the phases in ``HELD_PHASES`` (``to_hold``:
    the keys' digests, the inputs, outputs and decodings of their cold
    passes) against the same sessions on the CPU (``refs``), bit for bit;
    the wait counts to each phase."""
    print(f"phase references: {refs.workers} worker processes x {CPU_WORKER_THREADS} torch "
          f"threads, the main process {MAIN_THREADS}")
    for phase, tag, names in HELD_PHASES:
        card = to_hold[tag]
        cpus = [refs.get(name) for name in names]
        what = CPU_REFERENCES[names[0]]
        for k in what:
            # phase 13's references split the circuits between them
            cpu = {n: v for c in cpus for n, v in c[k].items()} if k == "out" else cpus[0][k]
            for c in cpus[1:]:
                assert k == "out" or c[k] == cpu, f"phase {phase} {k}: the references differ"
            assert _same(card[k], cpu), f"phase {phase} {k}: card != CPU"
        stages = "; ".join(", ".join(f"{k} {v / 1e3:.1f} s" for k, v in c["times"].items())
                           for c in cpus)
        print(f"phase {tag}: card == CPU (the same calls, the same generator seeds, the plain "
              f"NTT) for {', '.join(what)}, limb for limb and decoded; CPU reference "
              f"{sum(c['seconds'] for c in cpus):.1f} s in worker processes: {stages}")
        clock.done(phase)
    c = refs.get("ring switch")  # ring_switch_cpu's checks ran in the worker
    print("phase ring switch: card == CPU (the card's inputs and keys, the plain NTT) for "
          "switch_up, switch_down, expand, pack, split, merge and the monomials; CPU reference "
          f"{c['seconds']:.1f} s in a worker process: "
          + ", ".join(f"{k} {v / 1e3:.2f} s" for k, v in c["times"].items()))
    clock.done(17)


def rgsw_multiparty_phases(dev, smi: str, rng, int32_ops_per_s: float, clock: PhaseClock,
                           refs: CPUReferences) -> dict:
    """Phases 21-22 (see the module's docstring), held to the CPU references
    ``refs``; returns what the kernels line
    reports of B4 on these paths and B4's loss by shape over them."""
    from matrix_fhe_tpu_torch.schemes import ckks
    seen: dict = {}       # B4's calls by (direction, shape, moduli), phases 21-22
    launches: dict = {}   # and its launches there (cold passes), by phase
    counts: dict = {}
    walls: dict = {}      # the cold passes' wall times, s

    def cold_warm(phase, fn):
        """fn(times) in a cold pass (B4's calls recorded and its launches
        counted) and a warm one with the same seeds: (cold outputs, cold
        times, warm times, warm outputs)."""
        cold_t, warm_t = {}, {}
        t0 = time.perf_counter()
        out, counts[phase] = _b4_counted(dev, lambda: b4_shapes(
            lambda: fn(cold_t), seen, launches.setdefault(phase, {})))
        walls[phase] = time.perf_counter() - t0
        return out, cold_t, warm_t, fn(warm_t)

    def report(tag, cold_t, warm_t):
        for name, ms in cold_t.items():
            print(f"phase {tag}: {name:48s} cold {ms:10.3f} ms, warm {warm_t[name]:10.3f} ms"
                  f" | {smi}")

    # -- 21 (a). RGSW external products at logN 14 ------------------------------------------
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    r, cold_t, warm_t, warm = cold_warm("21a", lambda t: rgsw_session(dev, t))
    for k in ("sk", "cts", "rg", "outs", "dec"):
        assert _same(r[k], warm[k]), f"phase 21 {k}: warm pass != cold pass"
    del warm
    p = r["params"]
    print(f"phase rgsw: PN14QP438's chain at logN {p.log_n} ({len(p.q)} + {len(p.p)} primes, "
          f"scale 2^{SESSION_LOG_SCALE}); RGSW rows: standard gadget "
          f"{r['rg']['scalar'].g0.num_digits}, base-two B={RGSW_BASE_TWO} P-less "
          f"{r['rg']['base2'].g0.num_digits}")
    report("rgsw", cold_t, warm_t)
    for k, floor in RGSW_BOUNDS.items():
        st = ckks.precision_stats(r["want"][k], r["dec"][k])
        mean_bits = -np.log2(np.mean(np.abs(r["dec"][k] - r["want"][k])) + 1e-30)
        print(f"phase rgsw: external product {k:8s} min {st.min_precision:.4f} bits, mean "
              f"|error| {mean_bits:.4f} bits (floor {floor}: "
              f"{'tests/test_base2.py:97' if k == 'base2' else 'tests/test_rgsw.py'}) | {smi}")
        # tests/test_rgsw.py holds the min L2 precision, tests/test_base2.py:97 the mean error
        if k == "base2":
            assert mean_bits > floor, f"phase 21 {k}: below the floor"
        else:
            assert st.min_precision >= floor, f"phase 21 {k}: below the floor"
    cr = refs.get("rgsw")
    for k in ("sk", "cts", "rg", "outs"):
        assert _same(r[k], cr[k]), f"phase 21 {k}: card != CPU"
    for k in RGSW_BOUNDS:
        assert np.array_equal(r["dec"][k], cr["dec"][k]), f"phase 21 {k}: decoded, card != CPU"
    print(f"phase rgsw: card == CPU (the same calls, the same generator seeds, the plain NTT) "
          f"for the secrets, the 3 encryptions, the 3 RGSW ciphertexts, the 3 products and "
          f"their decodings (CPU reference {cr['seconds']:.2f} s, in a worker process); B4 "
          f"launches {counts['21a']}")
    del r, cr

    # -- 21 (b). blind rotation, ring logN 10 over LWE logN 9 --------------------------------
    b, cold_t, warm_t, warm = cold_warm("21b", lambda t: blindrot_session(dev, t))
    for k in ("keys", "test_poly", "ct", "out", "got"):
        assert _same(b[k], warm[k]), f"phase 21 blind rotation {k}: warm pass != cold pass"
    del warm
    pb, pl = b["params"]
    print(f"phase blindrot: ring logN {pb.log_n} (Q {pb.q[0]}, {pb.q[0].bit_length()} bits; P "
          f"{pb.p[0]}, {pb.p[0].bit_length()} bits), LWE logN {pl.log_n} (q {pl.q[0]}, "
          f"{pl.q[0].bit_length()} bits, ternary secret, density 2/3); {len(b['keys'][2].brks)} "
          f"RGSW keys, {len(b['keys'][2].gks)} galois keys")
    report("blindrot", cold_t, warm_t)
    slots = len(BR_VALUES)
    evaluate = f"evaluate, {slots} slots"
    print(f"phase blindrot: a slot: cold {cold_t[evaluate] / slots:.3f} ms, warm "
          f"{warm_t[evaluate] / slots:.3f} ms; B4 launches a slot "
          f"{ {d: n / slots for d, n in b['launches'].items()} } (evaluate's "
          f"{b['launches']} over {slots} slots) | {smi}")
    for i, (x, got, st) in enumerate(zip(BR_VALUES, b["got"], b["steps"])):
        err = abs(got - _sign(x))
        print(f"phase blindrot: slot {i}: sign({x:+.2f}) = {got:+.6f}, |error| {err:.6f} (bound "
              f"{BR_BOUND}: tests/test_blindrot.py); {st['product']} external products, "
              f"{st['auto']} automorphisms")
        assert err < BR_BOUND, f"phase 21 blind rotation slot {i}: |error| {err}"
    cb = refs.get("blindrot")
    for k in ("keys", "test_poly", "ct", "out", "got"):
        assert _same(b[k], cb[k]), f"phase 21 blind rotation {k}: card != CPU"
    print(f"phase blindrot: card == CPU (the same calls, the same generator seeds, the plain "
          f"NTT) for the keys (512 RGSW, 11 galois), the test polynomial, the LWE ciphertext, "
          f"the 4 blind-rotated slots and their decryptions (CPU reference "
          f"{cb['seconds']:.2f} s, in a worker process); B4 launches {counts['21b']}")
    blindrot29 = {k: b[k] for k in ("params", "keys", "test_poly", "ct", "out")}
    del b, cb
    peak = torch.cuda.max_memory_allocated()
    print(f"phase rgsw: peak device memory {(peak - held) / 2**20:.1f} MiB above the "
          f"{held / 2**20:.1f} MiB the earlier phases hold | {smi}")

    clock.done(21)

    # -- 22. the multiparty protocols at logN 14, 3 parties ----------------------------------
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    sums, restore = _python_int_timers()
    try:
        m, cold_t, warm_t, warm = cold_warm("22", lambda t: multiparty_session(dev, t))
    finally:
        restore()
    peak = torch.cuda.max_memory_allocated()
    for k in ("keys", "cts", "bct", "out", "dec"):
        assert _same(m[k], warm[k]), f"phase 22 {k}: warm pass != cold pass"
    del warm
    p = m["params"]
    print(f"phase multiparty: {MP_PARTIES} parties; CKKS on PN14QP438's chain at logN "
          f"{p.log_n}, BGV on phase 20's at logN {m['bparams'].log_n}, T = {m['bparams'].t}")
    report("multiparty", cold_t, warm_t)
    for name, ms in sums.items():
        print(f"phase multiparty: host time of {name}: {ms:.3f} ms (both passes)")
    print(f"phase multiparty: peak device memory {(peak - held) / 2**20:.1f} MiB above the "
          f"{held / 2**20:.1f} MiB the earlier phases hold | {smi}")
    for name, floor in MP_BOUNDS.items():
        st = ckks.precision_stats(m["want"][name], m["dec"][name])
        print(f"phase multiparty: {name:24s} min {st.min_precision:.4f} bits, mean "
              f"{st.avg_precision:.4f} bits (floor {floor}: tests/test_multiparty.py) | {smi}")
        assert st.min_precision >= floor, f"phase 22 {name}: below the floor"
    a, c = m["out"]["threshold 2-of-3"]
    ideal = m["ideal"].value
    assert torch.equal(p.ring_q.add(a.value.q, c.value.q), ideal.q) and \
        torch.equal(p.ring_p.add(a.value.p, c.value.p), ideal.p), "phase 22 threshold"
    print("phase multiparty: threshold 2-of-3: the combined shares of parties 1 and 3 sum to "
          "the ideal secret exactly")
    bdec = np.asarray(m["dec"]["BGV refresh"]).astype(np.int64)
    assert np.array_equal(bdec % m["bparams"].t, m["bv"]), "phase 22 BGV refresh"
    assert m["out"]["BGV refresh"][1].level == m["bparams"].max_level
    assert m["out"]["refresh"][1].level == p.max_level
    print(f"phase multiparty: BGV refresh level 0 -> {m['bparams'].max_level}: decoded == the "
          f"input mod T; CKKS refresh level 0 -> {p.max_level}")
    cm = refs.get("multiparty")
    for k in ("keys", "cts", "bct", "out"):
        assert _same(m[k], cm[k]), f"phase 22 {k}: card != CPU"
    for k in m["dec"]:
        assert np.array_equal(m["dec"][k], cm["dec"][k]), f"phase 22 {k}: decoded, card != CPU"
    print(f"phase multiparty: card == CPU (the same calls, the same generator seeds, the plain "
          f"NTT) for every share, key, ciphertext and decoding (CPU reference "
          f"{cm['seconds']:.2f} s, in a worker process); B4 launches {counts['22']}")
    del m, cm

    # -- B4 at every shape phases 21-22 gave it ------------------------------------------------
    shape_rows = check_b4_shapes(seen, dev, rng)
    for d, shape, c, err_, _ in shape_rows:
        assert err_ == 0, f"B4 {d} {shape}: kernel != plain ({err_})"
    ns = sorted({shape[-1] for _, shape, *_ in shape_rows})
    print(f"phase b4: B4 at the {len(shape_rows)} shapes (direction, shape, moduli) of phases "
          f"21-22, N = {ns}: kernel == plain at every one")
    loss = []
    for phase, counted in launches.items():
        rows = b4_loss(seen, counted, dev, rng, int32_ops_per_s, smi,
                       f"phase {phase}, {PHASE_NAMES[phase]}")
        busy = sum(r["launches"] * r["device_ms"] for r in rows)
        print(f"phase b4 loss: phase {phase}: B4 device time queued x launches {busy:.3f} ms = "
              f"{100 * busy / (walls[phase] * 1e3):.2f}% of the cold pass's "
              f"{walls[phase]:.3f} s wall time, bound x launches "
              f"{sum(r['launches'] * r['bound_ms'] for r in rows):.4f} ms | {smi}")
        loss += rows
    return {"shape_rows": shape_rows, "loss": loss, "blindrot": blindrot29,
            "by_path": {f"{PHASE_NAMES[k]} (phase {k})": v for k, v in counts.items()}}


# -- phases 23-25: the flagship step, serialization, the examples -----------------------------

def flagship_session(dev, times: dict) -> dict:
    """Phase 23's objects on ``dev``: flagship.build_flagship(*FLAGSHIP, seed=SEED) in its
    two parts (the draws on a CPU generator, then the keys, encode and encrypt) and one
    step; then phase 24's 8 galois keys (rotations 1-8) and an RGSW(3), each timed."""
    from matrix_fhe_tpu_torch import flagship, rgsw
    from matrix_fhe_tpu_torch.rlwe import decryptor, keys as K
    from matrix_fhe_tpu_torch.schemes import ckks
    params = _timed(times, "parameters (the rings' tables)", dev,
                    lambda: flagship.flagship_parameters(*FLAGSHIP, device=dev))
    s = _timed(times, "keygen draws (secret, relinearization rows, 2 encryptions)", dev,
               lambda: flagship.sample_flagship(torch.Generator().manual_seed(SEED), params))
    sk, rlk, ev, ct1, ct2 = _timed(times, "keygen + encode + encrypt, deterministic part", dev,
                                   lambda: flagship.flagship_from_samples(params, s, SEED))
    step = flagship.make_step(params, ev, ct1.metadata)
    out = _timed(times, "step, first call", dev, lambda: step(*ct1.value, *ct2.value, rlk))
    res = ev.rescale(ev.mul_relin(ct1, ct2))
    assert _same(tuple(res.value), tuple(out)), "make_step != rescale(mul_relin)"
    v1, v2 = flagship.flagship_vectors(params, SEED)
    dec = ckks.Encoder(params).decode(decryptor.decrypt(params, sk, res))
    gks = _timed(times, f"{len(SESSION_ROTATIONS)} galois keys (rotations 1-8)", dev,
                 lambda: K.gen_galois_keys(_gen(2301), params, sk,
                                           params.galois_elements(SESSION_ROTATIONS)))
    rg = _timed(times, "RGSW(3)", dev, lambda: rgsw.encrypt_plaintext(_gen(2302), params, sk, 3))
    objs = {"params": params, "sk": sk, "rlk": rlk, "ct1": ct1, "ct2": ct2,
            **{f"galois key {g}": k for g, k in gks.items()}, "rgsw": rg}
    return {"objs": objs, "step": step, "out": tuple(out), "dec": dec, "want": v1 * v2}


def flagship_reference(dev, times: dict) -> dict:
    """Phases 23-24 on ``dev`` from the seeds: the step's output, its decoding and the
    sha256 of each object's blob (utils/serialization.py)."""
    from matrix_fhe_tpu_torch.utils import serialization as ser
    f = flagship_session(dev, times)
    return {"out": f["out"], "dec": f["dec"],
            "blobs": {k: hashlib.sha256(ser.save(o)).hexdigest() for k, o in f["objs"].items()}}


def examples_reference(dev, times: dict) -> dict:
    """The 14 examples' ``main(device=dev, seed=SEED)``, their prints kept out of the
    output, each timed."""
    from matrix_fhe_tpu_torch.examples import NAMES
    outs = {}
    for name in NAMES:
        main_ = importlib.import_module(f"matrix_fhe_tpu_torch.examples.{name}").main
        with contextlib.redirect_stdout(io.StringIO()):
            outs[name] = _timed(times, name, dev, lambda: main_(device=dev, seed=SEED))
    return {"outs": outs}


def surface_phases(dev, smi: str, rng, int32_ops_per_s: float, clock: PhaseClock,
                   refs: CPUReferences) -> dict:
    """Phases 23-25 (see the module's docstring), held to the CPU references ``refs``;
    returns what the kernels line reports of B4 on these paths and B4's loss by shape
    over them."""
    from matrix_fhe_tpu_torch import flagship
    from matrix_fhe_tpu_torch.examples import NAMES
    from matrix_fhe_tpu_torch.ops import ntt64_cuda, ntt_cuda
    from matrix_fhe_tpu_torch.schemes import ckks
    from matrix_fhe_tpu_torch.utils import serialization as ser
    seen: dict = {}       # B4's calls by (direction, shape, moduli), phases 23-25
    launches: dict = {}   # and its launches there, by phase
    ci_seen: dict = {}
    ci_launches: dict = {}
    by_path: dict = {}

    def recorded(phase, fn, ci_ring=False):
        """fn() with B4's calls recorded and its launches counted (on the CI ring too
        with ``ci_ring``): (output, launches on the standard ring)."""
        def run():
            return b4_shapes(fn, seen, launches.setdefault(phase, {}))
        return _b4_counted(dev, lambda: _shapes_in(ntt64_cuda, run, ci_seen, CI_ENTRIES,
                                                   ci_launches) if ci_ring else run())

    # -- 23. the flagship step at PN14QP438 -----------------------------------------------------
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    times: dict = {}
    f, by_path["flagship setup, first step, 8 galois keys, RGSW (phases 23-24)"] = recorded(
        "23", lambda: flagship_session(dev, times))
    objs, step, out = f["objs"], f["step"], f["out"]
    params, sk, rlk, ct1, ct2 = (objs[k] for k in ("params", "sk", "rlk", "ct1", "ct2"))
    print(f"phase flagship: PN14QP438 at logN {params.log_n}: {len(params.q)} + {len(params.p)} "
          f"primes ({', '.join(str(q.bit_length()) for q in params.q + params.p)} bits), scale "
          f"2^{params.log_default_scale}, {params.max_slots} slots; none cut")
    for name, ms in times.items():
        print(f"phase flagship: {name:58s} {ms:10.3f} ms | {smi}")
    again = flagship.build_flagship(*FLAGSHIP, seed=SEED, device=dev)
    assert _same((again[1], again[2], again[4], again[5]), (sk, rlk, ct1, ct2)), \
        "phase 23: build_flagship != its two parts"
    del again
    args = (*ct1.value, *ct2.value, rlk)
    lat, steps = [], []
    for r in range(FLAGSHIP_REQUESTS + FLAGSHIP_REPEATS):
        torch.cuda.synchronize()
        ntt64_cuda.fwd_launches = ntt64_cuda.bwd_launches = 0
        t0 = time.perf_counter()
        o, launched = _launched(ntt64_cuda, lambda: step(*args))
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t0) * 1e3)
        steps.append(launched)
        assert _same(tuple(o), out), f"phase 23 request {r}: != the first step"
    peak = torch.cuda.max_memory_allocated()
    assert all(c == steps[0] for c in steps) and min(steps[0].values()) > 0, steps
    by_path["flagship step (phase 23, a request)"] = steps[0]
    reps = lat[FLAGSHIP_REQUESTS:]
    print(f"phase flagship: step rescale(mul_relin): requests "
          f"{', '.join(f'{t:.3f}' for t in lat[:FLAGSHIP_REQUESTS])} ms; median of "
          f"{len(reps)} more {statistics.median(reps):.3f} ms (min {min(reps):.3f}, max "
          f"{max(reps):.3f}) | {smi}")
    print(f"phase flagship: B4 launches a step {steps[0]}; peak device memory "
          f"{(peak - held) / 2**20:.1f} MiB above the {held / 2**20:.1f} MiB the earlier phases "
          f"hold | {smi}")
    st = ckks.precision_stats(f["want"], f["dec"])
    print(f"phase flagship: decoded min precision {st.min_precision:.4f} bits, mean "
          f"{st.avg_precision:.4f} bits over {len(f['dec'])} slots (floor {FLAGSHIP_FLOOR}: "
          f"tests/test_ckks.py:90-97)")
    assert st.min_precision >= FLAGSHIP_FLOOR, "phase 23: below the floor"
    cf = refs.get("flagship")
    assert _same(out, cf["out"]) and np.array_equal(f["dec"], cf["dec"]), "phase 23: card != CPU"
    print(f"phase flagship: card == CPU (build_flagship from the same seed, the same step, the "
          f"plain NTT) for the step's output and its decoding (CPU reference "
          f"{cf['seconds']:.2f} s in a worker process: "
          + ", ".join(f"{k} {v / 1e3:.2f} s" for k, v in cf["times"].items()) + ")")
    clock.done(23)

    # -- 24. serialization at full width ----------------------------------------------------
    ntt_cuda.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    rows, loaded = [], {}
    with tempfile.TemporaryDirectory(dir=ntt_cuda.BUILD_DIR) as tmp:
        for name, obj in objs.items():
            path = f"{tmp}/{name.replace(' ', '_')}.bin"
            _sync(dev)
            t0 = time.perf_counter()
            with open(path, "wb") as fh:
                nbytes = ser.save(obj, fh)
            t1 = time.perf_counter()
            with open(path, "rb") as fh:
                data = fh.read()
            t2 = time.perf_counter()
            back = ser.load(data, device=dev)
            _sync(dev)
            t3 = time.perf_counter()
            assert len(data) == nbytes
            loaded[name] = back
            rows.append((name, nbytes, (t1 - t0) * 1e3, (t3 - t2) * 1e3,
                         hashlib.sha256(data).hexdigest()))
    saved_b = sum(r[1] for r in rows)
    save_ms, load_ms = sum(r[2] for r in rows), sum(r[3] for r in rows)
    for name, nbytes, s_ms, l_ms, _ in rows:
        print(f"phase serialization: {name:16s} {nbytes:11d} B, save {s_ms:9.3f} ms, load to "
              f"the card {l_ms:9.3f} ms{' (the rings regenerated)' if name == 'params' else ''}")
    print(f"phase serialization: {len(rows)} objects, {saved_b} B: save (card -> host -> file) "
          f"{save_ms:.3f} ms = {saved_b / 1e6 / (save_ms / 1e3):.1f} MB/s, load (file bytes -> "
          f"card) {load_ms:.3f} ms = {saved_b / 1e6 / (load_ms / 1e3):.1f} MB/s | {smi}")
    lp = loaded["params"]
    assert (lp.q, lp.p, lp.n) == (params.q, params.p, params.n)
    assert all(torch.equal(getattr(lp.ring_q, t), getattr(params.ring_q, t)) for t in
               ("psi2", "ipsi2")), "phase 24: the reloaded rings' tables differ"
    for name, obj in objs.items():
        assert name == "params" or _same(loaded[name], obj), f"phase 24 {name}: reloaded != saved"
    lct1, lct2 = loaded["ct1"], loaded["ct2"]
    o, by_path["the reloaded objects' step (phase 24)"] = recorded("24", lambda: flagship.make_step(
        lp, None, lct1.metadata)(*lct1.value, *lct2.value, loaded["rlk"]))
    assert _same(tuple(o), out), "phase 24: the reloaded objects' step != phase 23's"
    blobs = {name: digest for name, _, _, _, digest in rows}
    assert blobs == cf["blobs"], "phase 24: a blob on the card != the CPU's"
    wp = ckks.new_parameters(ckks.CKKSParametersLiteral(**WIRE_LITERAL), dev)
    v = np.arange(wp.max_slots) / wp.max_slots + 0j
    assert hashlib.sha256(ser.save(ckks.Encoder(wp).encode(v))).hexdigest() == WIRE_PT_SHA256, \
        "phase 24: the wire-format plaintext digest"
    print(f"phase serialization: the reloaded params, keys and ciphertexts run the step "
          f"bit-identically; every blob's sha256 == the CPU worker's blob of the same object; "
          f"the card's encoder reproduces tests/test_serialization.py:105's plaintext digest")
    flagship29 = {"params": params, "rlk": rlk, "ct1": ct1, "ct2": ct2, "step": step,
                  "gks": {k.gal_el: k for name, k in objs.items() if name.startswith("galois")}}
    del loaded, objs, f, step
    clock.done(24)

    # -- 25. the 14 examples on the card --------------------------------------------------
    ce = refs.get("examples")
    ex_ms = {}
    for name in NAMES:
        main_ = importlib.import_module(f"matrix_fhe_tpu_torch.examples.{name}").main
        buf = io.StringIO()
        _sync(dev)
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            res, c = recorded(name, lambda: main_(device=dev, seed=SEED),
                              ci_ring=name == "ckks_scheme_switching")
        _sync(dev)
        ex_ms[name] = (time.perf_counter() - t0) * 1e3
        assert min(c.values()) > 0, f"phase 25 {name}: B4 launched no time ({c})"
        by_path[f"example {name} (phase 25)"] = c
        for line in buf.getvalue().splitlines():
            print(f"phase examples: {name}: {line}")
        assert _same(res, ce["outs"][name]), f"phase 25 {name}: card != CPU"
        print(f"phase examples: {name}: {ex_ms[name]:.1f} ms on the card (CPU reference "
              f"{ce['times'][name] / 1e3:.2f} s), B4 launches {c}; every assert passed; card "
              f"== CPU for the decrypted words and the decoded values | {smi}")
    ci_by = {d: sum(n for (dd, *_), n in ci_launches.items() if dd == d) for d in ("fwd", "bwd")}
    assert sum(ci_by.values()) > 0, f"phase 25: B4's CI mode launched no time ({ci_by})"
    print(f"phase examples: all {len(NAMES)} in {sum(ex_ms.values()) / 1e3:.2f} s on the card; "
          f"B4 on the CI ring (ckks_scheme_switching) {ci_by}")

    # -- B4 at every shape phases 23-25 gave it --------------------------------------------
    shape_rows = check_b4_shapes(seen, dev, rng)
    for d, shape, c, err_, _ in shape_rows:
        assert err_ == 0, f"B4 {d} {shape}: kernel != plain ({err_})"
    ns = sorted({shape[-1] for _, shape, *_ in shape_rows})
    print(f"phase b4: B4 at the {len(shape_rows)} shapes (direction, shape, moduli) of phases "
          f"23-25, N = {ns}: kernel == plain at every one")
    ci_rows = check_ci_shapes(ci_seen, dev, rng)
    for d, shape, err_, _, names, _ in ci_rows:
        assert err_ == 0, f"B4 on the CI ring {d} {shape}: kernel != plain ({err_})"
        assert len(names) == 3 and all("ntt64" in k for k in names), (d, shape, names)
    print(f"phase b4: B4 on the CI ring at the {len(ci_rows)} shapes of phase 25: kernel == "
          f"plain, one kernel a call")
    loss = [row for phase, counted in launches.items() for row in b4_loss(
        seen, counted, dev, rng, int32_ops_per_s, smi,
        f"phase {phase}, {PHASE_NAMES[phase]}" if phase in PHASE_NAMES else f"phase 25, {phase}")]
    ci_loss = b4_loss(ci_seen, ci_launches, dev, rng, int32_ops_per_s, smi,
                      "phase 25, CI ring", ci=True)
    clock.done(25)
    return {"shape_rows": shape_rows, "ci_rows": ci_rows, "loss": loss, "ci_loss": ci_loss,
            "by_path": by_path, "ci_launches": ci_by, "flagship": flagship29}


# -- 29. the key-switch graph caches ---------------------------------------------------------

GRAPH_REPEATS = 10        # eager and graphed calls timed an item (the blind-rotated slot: 3)
GRAPH_SLOT_REPEATS = 3


def key_switch_graphs() -> list:
    """Every captured graph of the key-switch caches (rlwe/evaluator.py's and
    rlwe/keys.py's): (cache key, utils/graphs.py Graph)."""
    from matrix_fhe_tpu_torch.rlwe import evaluator as rlwe_eval, keys as K
    return [(key, g) for cache in (rlwe_eval._GRAPH_CACHE, K._EVK_GRAPH_CACHE)
            for key, fn in cache.items() for g in fn.entries.values()]


def clear_key_switch_graphs() -> None:
    """Both key-switch caches emptied, every graph freed."""
    from matrix_fhe_tpu_torch.rlwe import evaluator as rlwe_eval, keys as K
    for cache in (rlwe_eval._GRAPH_CACHE, K._EVK_GRAPH_CACHE):
        for fn in cache.values():
            fn.release()
        cache.clear()


def _ntt_entries() -> dict:
    """B4's entry points (its CI mode with them: one kernel) and B5's:
    (module, entry point, its count, direction)."""
    from matrix_fhe_tpu_torch.ops import ntt3n_cuda, ntt64_cuda
    return {"B4": [(ntt64_cuda, "ntt_fwd", "fwd_launches", "fwd"),
                   (ntt64_cuda, "ntt_bwd", "bwd_launches", "bwd"),
                   (ntt64_cuda, "ntt_ci_fwd", "ci_fwd_launches", "fwd"),
                   (ntt64_cuda, "ntt_ci_bwd", "ci_bwd_launches", "bwd")],
            "B5": [(ntt3n_cuda, "ntt_fwd", "fwd_launches", "fwd"),
                   (ntt3n_cuda, "ntt_bwd", "bwd_launches", "bwd")]}


def _by_kernel(count) -> dict:
    """{"B4" and "B5": {direction: the sum of count(module, entry point, counter)}}."""
    return {k: {d: sum(count(m, e, c) for m, e, c, dd in rows if dd == d) for d in ("fwd", "bwd")}
            for k, rows in _ntt_entries().items()}


def _ntt_launched(fn):
    """fn() and B4's and B5's launches in it, by direction: those their
    wrappers made (counts zeroed just before, read just after) and those
    the CUDA graphs replayed (utils/graphs.py replays)."""
    from matrix_fhe_tpu_torch.utils import graphs
    for rows in _ntt_entries().values():
        for m, _, c, _ in rows:
            setattr(m, c, 0)
    with graphs.replays() as rep:
        out = fn()
    return (out, _by_kernel(lambda m, e, c: getattr(m, c)),
            _by_kernel(lambda m, e, c: rep.count(f"{m.__name__}.{e}")))


def _ntt_nodes(names) -> dict:
    return {k: {d: sum(f"{tag}_{d}_kernel" in n for n in names) for d in ("fwd", "bwd")}
            for k, tag in (("B4", "ntt64"), ("B5", "ntt3n"))}


def check_graph_nodes() -> list:
    """Each graph of the key-switch caches against its eager body on the
    graph's static inputs: its kernel nodes by name == a capture of the
    eager body's, and its B4 and B5 nodes == the launches its capture
    recorded (what each replay counts).  One row a graph: (cache key,
    kernel nodes, B4 and B5 nodes, other nodes)."""
    from matrix_fhe_tpu_torch.utils import launches
    rows = []
    for key, g in key_switch_graphs():
        names = launches.graph_nodes(g.graph)
        kernels = [n for n in names if not n.startswith("node type")]
        body = [n for n in launches.graph_kernels(g.eager, calls=1)
                if not n.startswith("node type")]
        assert sorted(kernels) == sorted(body), f"phase 29 {key}: kernel nodes != the body's"
        nodes = _ntt_nodes(kernels)
        recorded = _by_kernel(lambda m, e, c: g.launches.count(f"{m.__name__}.{e}"))
        assert nodes == recorded, f"phase 29 {key}: NTT nodes {nodes} != recorded {recorded}"
        rows.append((key, len(kernels), nodes, len(names) - len(kernels)))
    return rows


def _static_bytes(graph_list) -> int:
    """The bytes of the distinct static input buffers of ``graph_list``
    (utils/graphs.py Graphs, which share them by shape)."""
    return sum({t.data_ptr(): t.numel() * t.element_size()
                for g in graph_list for t in g.inputs}.values())


def graph_item(name: str, fn, dev, smi: str, repeats: int = GRAPH_REPEATS,
               want=None, want_from: str = "") -> dict:
    """Phase 29 on one path: fn() through the key-switch graph caches,
    emptied first, against fn() within ``graphs.eager()`` (and ``want``,
    the earlier phase's output, where given): the first call (warm-up and
    capture apart), a second call, the graphs' nodes against the eager
    bodies and the launches their captures recorded, B4's and B5's launches
    of an eager call against those of a graphed one (its wrappers' and its
    graphs' replays, == the graphs' nodes times their replays), both
    latencies, the cache's entries, the pool, the static inputs and the
    peak memory."""
    from matrix_fhe_tpu_torch.utils import graphs
    clear_key_switch_graphs()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    first = fn()
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    seconds = [g.seconds for _, g in key_switch_graphs()]
    warm_s, capture_s = (sum(x[k] for x in seconds) for k in ("warm-up", "capture"))
    with graphs.eager():
        eager, eager_n, eager_replayed = _ntt_launched(fn)
    assert _same(first, eager), f"phase 29 {name}: graphed != eager"
    assert eager_replayed == {k: {"fwd": 0, "bwd": 0} for k in ("B4", "B5")}, eager_replayed
    if want is not None:
        assert _same(first, want), f"phase 29 {name}: != {want_from}'s output"
    for _, g in key_switch_graphs():
        g.replays = 0
    again, outside, in_graphs = _ntt_launched(fn)
    assert _same(again, eager), f"phase 29 {name}: a second graphed call != eager"
    replays = [g.replays for _, g in key_switch_graphs()]
    rows = check_graph_nodes()   # in key_switch_graphs' order
    nodes_x = {k: {d: sum(r[2][k][d] * n for r, n in zip(rows, replays)) for d in ("fwd", "bwd")}
               for k in ("B4", "B5")}
    assert in_graphs == nodes_x, f"phase 29 {name}: replayed {in_graphs} != nodes x replays"
    total = {k: {d: outside[k][d] + in_graphs[k][d] for d in ("fwd", "bwd")} for k in outside}
    assert total == eager_n, f"phase 29 {name}: launches {total} != the eager call's {eager_n}"
    lat = {}
    for what in ("eager", "graphed"):
        ts = []
        for _ in range(repeats):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if what == "eager":
                with graphs.eager():
                    fn()
            else:
                fn()
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t0) * 1e3)
        lat[what] = ts
    from matrix_fhe_tpu_torch.rlwe import evaluator as rlwe_eval, keys as K
    entries = {c: (len(cache), sum(len(f.entries) for f in cache.values()))
               for c, cache in (("evaluator", rlwe_eval._GRAPH_CACHE),
                                ("keygen", K._EVK_GRAPH_CACHE))}
    pool = _pool_bytes(graphs.SHARED.pool(dev))
    pool_held = _pool_bytes(graphs.SHARED.pool(dev), held=True)
    static = _static_bytes([g for _, g in key_switch_graphs()])
    peak = torch.cuda.max_memory_allocated() - held
    med = {k: statistics.median(v) for k, v in lat.items()}
    print(f"phase graphs: {name}: graphed == eager bit for bit"
          f"{f' == {want_from}' if want is not None else ''}, first and second call; eager "
          f"median {med['eager']:.3f} ms, graphed median {med['graphed']:.3f} ms ({repeats} "
          f"calls each; graphed {', '.join(f'{t:.3f}' for t in lat['graphed'])}) | {smi}")
    print(f"phase graphs: {name}: first call {first_s * 1e3:.3f} ms: eager warm-up "
          f"{warm_s * 1e3:.3f} ms, capture + instantiate {capture_s * 1e3:.3f} ms, the rest "
          f"{(first_s - warm_s - capture_s) * 1e3:.3f} ms | {smi}")
    print(f"phase graphs: {name}: cache entries: evaluator {entries['evaluator'][0]} keys / "
          f"{entries['evaluator'][1]} graphs, keygen {entries['keygen'][0]} / "
          f"{entries['keygen'][1]}; the shared pool {pool / 2**20:.1f} MiB (the most it has "
          f"held: a freed graph's blocks stay in it), {pool_held / 2**20:.1f} MiB of it in use "
          f"by these graphs; their static inputs {static / 2**20:.1f} MiB (shared by shape); "
          f"peak device memory {peak / 2**20:.1f} MiB above the {held / 2**20:.1f} MiB held "
          f"before | {smi}")
    print(f"phase graphs: {name}: a call: B4 {eager_n['B4']} and B5 {eager_n['B5']} launches "
          f"eager; graphed {outside['B4']} / {outside['B5']} by the wrappers + "
          f"{in_graphs['B4']} / {in_graphs['B5']} replayed by the graphs (== kernel nodes x "
          f"replays)")
    for (key, kernels, nodes, other), n in zip(rows, replays):
        what = f"{key[0]} at level {key[-1]}" if isinstance(key[0], str) else "evaluation key"
        print(f"phase graphs: {name}:   graph {what} ({n} replays a call): {kernels} kernel "
              f"nodes == the eager body's by name; B4 {nodes['B4']}, B5 {nodes['B5']} == the "
              f"launches its capture recorded; {other} other nodes")
    return {"median": med, "lat": lat, "first_s": first_s, "warm_s": warm_s,
            "capture_s": capture_s, "entries": entries, "pool": pool, "pool_held": pool_held,
            "static": static, "peak": peak, "eager_launches": eager_n, "outside": outside,
            "in_graphs": in_graphs, "graphs": len(rows)}


def graph_phase(dev, smi: str, sessions: dict, clock: PhaseClock) -> dict:
    """Phase 29 (see the module's docstring) on the sessions of phases 8,
    15, 16, 21 and 23; returns each item's numbers."""
    from matrix_fhe_tpu_torch.rgsw import blindrot
    from matrix_fhe_tpu_torch.rlwe import keys as K
    from matrix_fhe_tpu_torch.schemes import ckks
    out = {}
    f = sessions["flagship"]
    fev = ckks.Evaluator(f["params"], rlk=f["rlk"], galois_keys=f["gks"])
    ct1, ct2 = f["ct1"], f["ct2"]
    out["flagship"] = graph_item(
        f"flagship step + {len(SESSION_ROTATIONS)} rotations (phase 23's session)",
        lambda: (tuple(f["step"](*ct1.value, *ct2.value, f["rlk"])),
                 [fev.rotate(ct1, k) for k in SESSION_ROTATIONS]), dev, smi)
    b = sessions["blindrot"]
    bev = blindrot.Evaluator(*b["params"])
    out["blindrot"] = graph_item(
        "a blind-rotated slot (phase 21's session)",
        lambda: bev.evaluate(b["ct"], {0: b["test_poly"]}, b["keys"][2]), dev, smi,
        repeats=GRAPH_SLOT_REPEATS, want={0: b["out"][0]}, want_from="phase 21")
    m = sessions["matrix"]
    mul = matrix_ops(m["params"], m["keys"][1], m["keys"][2])["mul_relin + rescale"]
    out["matrix"] = graph_item(
        "Matrix-CKKS mul_relin + rescale (phase 15's session)", lambda: mul(*m["cts"]), dev,
        smi, want=m["outs"]["mul_relin + rescale"], want_from="phase 15")
    c = sessions["ci"]
    cp = c["params"]
    cev = ckks.Evaluator(cp, rlk=c["keys"][1])
    out["ci"] = graph_item(
        "CI mul_relin + rescale (phase 16's session)",
        lambda: cev.rescale(cev.mul_relin(*c["cts"])), dev, smi,
        want=c["outs"]["mul_relin + rescale"], want_from="phase 16")
    s8 = sessions["session"]
    p8, sk8 = s8["params"], s8["sk"]
    samples = {p8.galois_element(k): K.sample_evaluation_key(_gen(10 + k), p8)
               for k in SESSION_ROTATIONS}
    out["keygen"] = graph_item(
        f"phase 8's {len(samples)} galois keys, deterministic part",
        lambda: {g: K.galois_key_from_samples(p8, sk8, g, s) for g, s in samples.items()},
        dev, smi, want=s8["gks"], want_from="phase 8")
    del samples
    clear_key_switch_graphs()
    clock.done(29)
    return out


# -- 26. the multi-device code --------------------------------------------------------------

# B6's operations bound: a 64 x 64 -> 128 bit product a multiply-accumulate, one Montgomery
# reduction (a low and a high half) an output word, and both for a twiddle product
B6_MULS_MAC = 8
B6_MULS_REDUCE = MULS_LO + MULS_HI
B6_MULS_TWIDDLE = B6_MULS_MAC + B6_MULS_REDUCE


def _b6_bound(lead: int, limbs: int, R: int, C: int, c: int, int32_ops_per_s: float):
    """(bytes time, operations time) in ms of one B6 local step on a block of c columns of
    [lead, limbs, R, C]: 8 B a word of the block, of A, of the T columns and B^T rows the
    block needs, and of the [lead, limbs, R, C] partial; lead x limbs x R x c x (R + C)
    multiply-accumulates, one reduction an output word of either product (R x (c + C) a
    row) and one twiddle product a word of A @ x, in multiply-adds on the FMA pipe."""
    words = lead * limbs * R * c + limbs * R * R + 2 * limbs * R * c + lead * limbs * R * C
    macs = lead * limbs * R * c * (R + C)
    fmas = (B6_MULS_MAC * macs + B6_MULS_REDUCE * lead * limbs * R * (c + C)
            + B6_MULS_TWIDDLE * lead * limbs * R * c)
    return 8 * words / HBM_BYTES_PER_S * 1e3, fmas / (int32_ops_per_s / 2) * 1e3


def _rank_counts() -> dict:
    """The collectives and the kernel launches counted in this rank since the reset."""
    from matrix_fhe_tpu_torch.ops import ntt64_cuda, ntt_cuda, ntt_sharded_cuda
    from matrix_fhe_tpu_torch.parallel import api
    return {**api.counts, "b6": ntt_sharded_cuda.launches,
            "b1_fwd": ntt_cuda.fwd_launches, "b1_bwd": ntt_cuda.bwd_launches,
            "b4_fwd": ntt64_cuda.fwd_launches, "b4_bwd": ntt64_cuda.bwd_launches}


def _reset_rank_counts() -> None:
    from matrix_fhe_tpu_torch.ops import ntt64_cuda, ntt_cuda, ntt_sharded_cuda
    from matrix_fhe_tpu_torch.parallel import api
    api.reset_counts()
    ntt_sharded_cuda.launches = 0
    ntt_cuda.fwd_launches = ntt_cuda.bwd_launches = 0
    ntt64_cuda.fwd_launches = ntt64_cuda.bwd_launches = 0


def _kernel_shapes(fn):
    """(fn(), the shapes it gave B1, B4 and B6) as keys that pickle: {"b1" and "b4":
    [(direction, shape, moduli)], "b6": [(block shape, first column, N, moduli)]}."""
    from matrix_fhe_tpu_torch.ops import ntt_sharded_cuda
    b4_seen, b6_seen, box = {}, set(), []
    local = ntt_sharded_cuda.local_step

    def b6(x, tabs, col0):
        b6_seen.add((tuple(x.shape), col0, tabs.n, tuple(tabs.moduli.tolist())))
        return local(x, tabs, col0)

    ntt_sharded_cuda.local_step = b6
    try:
        b1_seen = ntt_shapes(lambda: box.append(b4_shapes(fn, b4_seen)))
    finally:
        ntt_sharded_cuda.local_step = local
    return box[0], {"b1": sorted({(d, shape, tuple(tabs.moduli.tolist()))
                                  for (d, shape, _), tabs in b1_seen.items()}),
                    "b4": sorted(b4_seen), "b6": sorted(b6_seen)}


def _rank_call(call, mesh, axis: str, repeats: int, **outputs) -> dict:
    """A rank's result for one sharded call: call() once with the counts zeroed just
    before and read just after and its kernels' shapes recorded, then ``repeats`` more
    calls, each timed between a barrier and a device synchronize (ms); ``outputs`` maps
    each output's name to a function of call()'s result that gives its numpy words."""
    import torch.distributed as dist
    dev = mesh.device
    _sync(dev)
    _reset_rank_counts()
    out, shapes = _kernel_shapes(call)
    _sync(dev)
    counts = _rank_counts()
    times = []
    for _ in range(repeats):
        dist.barrier()
        _sync(dev)
        t0 = time.perf_counter()
        call()
        _sync(dev)
        times.append((time.perf_counter() - t0) * 1e3)
    backend = str(dist.get_backend(mesh.group(axis)))
    return {**{k: f(out) for k, f in outputs.items()}, "counts": counts, "shapes": shapes,
            "times": times, "coords": dict(zip(mesh.axis_names, mesh.coords)),
            "transport": backend + (" through host memory" if backend == "gloo"
                                    and dev.type == "cuda" else "")}


def _case_mesh(case: dict, axis: str, device_type: str, meshes: dict):
    """The case's mesh ("axes", else ``axis`` over the world), made once a world for each
    set of axes (every rank makes the same ones in the same order)."""
    import torch.distributed as dist
    from matrix_fhe_tpu_torch.parallel import api
    axes = case.get("axes") or {axis: dist.get_world_size()}
    key = tuple(axes.items())
    if key not in meshes:
        meshes[key] = api.make_mesh(dict(axes), device_type)
    return meshes[key]


def _select(results: list, **coords) -> list:
    """The results of the ranks at ``coords`` on the axes named, in rank order."""
    return [r for r in results if all(r["coords"][a] == c for a, c in coords.items())]


def world26(ntt_cases: list, fast_cases: list, pk_args, repeats: int,
            device_type: str = "cuda") -> dict:
    """A rank's body in phase 26 (parallel/launch.py), one world for the three sharded
    functions, each on this rank's block of its case (``_rank_call``):

      * "ntt": ``ntt_sharded`` over the "seq" axis for each case {"n", "moduli", "x":
        [.., L, N] words} (this rank's column block of the output, "out");
      * "fast": ``build_sharded_step`` over the "limb" axis at ``make_synthetic_context``
        of each case's arguments (with "batch": B, B copies of the operands rolled by
        0 .. B-1 along N, split over a "batch" axis where the mesh has one): this rank's
        output blocks "o0", "o1";
      * "pk": ``collective_pk_over_mesh_from_samples`` over a "party" axis of the world
        at the literal, the parties' (secret, noise) draws and the common polynomial's
        (Q, P) draws of ``pk_args``: the key's (Q, P) words "pk".

    Also the seconds each took in this rank ("marks") and the body's start and end on the
    host's clock ("epoch")."""
    import torch.distributed as dist
    from matrix_fhe_tpu_torch.fast import fckks
    from matrix_fhe_tpu_torch.multiparty import mesh as mpm
    from matrix_fhe_tpu_torch.multiparty import protocols
    from matrix_fhe_tpu_torch.parallel import api, fast_sharded
    from matrix_fhe_tpu_torch.parallel import ntt_sharded as sh
    from matrix_fhe_tpu_torch.schemes import ckks
    started, t0 = time.time(), time.perf_counter()
    out, meshes = {"ntt": [], "fast": []}, {}
    for case in ntt_cases:
        mesh = _case_mesh(case, "seq", device_type, meshes)
        tabs = sh.build_tables(case["n"], case["moduli"], mesh.device)
        x = sh.shard_columns(torch.from_numpy(case["x"]), tabs, mesh.shape["seq"],
                             mesh.index("seq")).to(mesh.device)
        out["ntt"].append(_rank_call(lambda: sh.ntt_sharded(x, tabs, mesh), mesh, "seq", repeats,
                                     out=lambda o: o.cpu().numpy()))
    t1 = time.perf_counter()
    for case in fast_cases:
        mesh = _case_mesh(case, "limb", device_type, meshes)
        ctx, cts = fckks.make_synthetic_context(case["logn"], case["num_q"], case["num_p"],
                                                rescale_limbs=case["rescale_limbs"],
                                                seed=case["seed"], device=mesh.device)
        if case["batch"]:
            cts = tuple(torch.stack([torch.roll(v, b, dims=-1) for b in range(case["batch"])])
                        for v in cts)
        blocks = api.shard_ciphertext_batch(mesh, cts, limbs=True)
        fn = fast_sharded.build_sharded_step(ctx, mesh)
        out["fast"].append(_rank_call(lambda: fn(*blocks), mesh, "limb", repeats,
                                      o0=lambda o: o[0].cpu().numpy(),
                                      o1=lambda o: o[1].cpu().numpy()))
    t2 = time.perf_counter()
    literal, samples, crp = pk_args
    mesh = api.make_mesh({"party": dist.get_world_size()}, device_type)
    params = ckks.new_parameters(ckks.CKKSParametersLiteral(**literal), mesh.device)
    draws = [mpm.PartySample(secret=torch.from_numpy(s), noise=torch.from_numpy(e))
             for s, e in samples]
    crp_qp = protocols.crp_qp_from_samples(params, *(torch.from_numpy(a) for a in crp))
    out["pk"] = _rank_call(
        lambda: mpm.collective_pk_over_mesh_from_samples(params, mesh, draws, crp_qp), mesh,
        "party", repeats, pk=lambda o: tuple(v.cpu().numpy() for v in (o[0].value[0].q,
                                                                        o[0].value[0].p)))
    out["marks"] = {"ntt": t1 - t0, "step": t2 - t1, "public key": time.perf_counter() - t2}
    out["epoch"] = (started, time.time())
    return out


def _world_ms(per_rank: list) -> float:
    """The median over the timed calls of the slowest rank's wall time, ms."""
    return float(statistics.median(np.max(np.array([r["times"] for r in per_rank]), axis=0)))


def _mesh_label(per_rank: list) -> str:
    """The mesh's axes and sizes, from the last rank's coordinates."""
    return " x ".join(f"{a} {c + 1}" for a, c in per_rank[-1]["coords"].items())


def _ptxas_lines(log_path) -> list:
    """ptxas's register and spill lines of a build log."""
    return [line.strip() for line in log_path.read_text().splitlines()
            if "registers" in line or "spill" in line]


def parallel_phase(dev, smi: str, rng, int32_ops_per_s: float, clock: PhaseClock) -> dict:
    """Phase 26 (see the module's docstring): returns the kernels line's B6 entry."""
    from matrix_fhe_tpu_torch import flagship
    from matrix_fhe_tpu_torch.fast import fckks
    from matrix_fhe_tpu_torch.multiparty import mesh as mpm
    from matrix_fhe_tpu_torch.multiparty import protocols
    from matrix_fhe_tpu_torch.ops import ntt_cuda, ntt_sharded_cuda, rings
    from matrix_fhe_tpu_torch.parallel import launch
    from matrix_fhe_tpu_torch.parallel import ntt_sharded as sh
    from matrix_fhe_tpu_torch.rlwe import decryptor, encryptor
    from matrix_fhe_tpu_torch.rlwe import keys as K
    from matrix_fhe_tpu_torch.schemes import ckks
    from matrix_fhe_tpu_torch.schemes.ckks import precision

    # -- B6 against its plain version on the card at the shard shapes, and timed ---------
    n = 1 << LOGN
    fp = flagship.flagship_parameters(*FLAGSHIP, device=dev)
    moduli = list(fp.q) + list(fp.p)
    tabs = sh.build_tables(n, moduli, dev)
    L, R, C = len(moduli), tabs.rows, tabs.cols
    x_cpu = _words(rng, (PAR_NTT_LEAD,), moduli, n)
    x = x_cpu.to(dev)
    print(f"phase parallel: the sharded NTT at N = 2^{LOGN} on the flagship's {L} moduli "
          f"({', '.join(str(q.bit_length()) for q in moduli)} bits), input "
          f"[{PAR_NTT_LEAD}, {L}, {n}] = [{PAR_NTT_LEAD}, {L}, {R}, {C}]")
    log = ntt_cuda.library_path(ntt_sharded_cuda.BUILD_KEY, ntt_sharded_cuda.SOURCE)
    for line in _ptxas_lines(log.with_suffix(".log")):
        print(f"phase parallel: B6 ptxas: {line}")
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    err, b6, b6_held = 0, {}, set()
    for k in PAR_NTT_SHARDS:
        c = C // k
        for i in range(k):
            blk = sh.shard_columns(x, tabs, k, i)
            got = ntt_sharded_cuda.local_step(blk, tabs, i * c)
            want = ntt_sharded_cuda.local_step_plain(blk, tabs, i * c)
            err = max(err, int((got - want).abs().max()))
            b6_held.add((tuple(blk.shape), i * c, n, tuple(moduli)))
        blk = sh.shard_columns(x, tabs, k, 0)

        def call():
            return ntt_sharded_cuda.local_step(blk, tabs, 0)
        t = {"ms": _event_ms(call), "device": _device_ms(call),
             "flushed": _flushed_ms(call, flush), "host": _host_ms(call),
             "plain_ms": _event_ms(lambda: ntt_sharded_cuda.local_step_plain(blk, tabs, 0),
                                   iters=5, warmup=1)}
        bound = _b6_bound(PAR_NTT_LEAD, L, R, C, c, int32_ops_per_s)
        b6[k] = (t, bound)
        print(f"phase parallel: B6 at a k = {k} shard's block {list(blk.shape)} -> "
              f"{[PAR_NTT_LEAD, L, R, C]} (threads, ti, cn) "
              f"{ntt_sharded_cuda.geometry(R, C, c)[:3]}: kernel {t['ms']:.4f} ms, device queued "
              f"{t['device']:.4f} ms, L2 flushed {t['flushed']:.4f} ms, host {t['host']:.4f} ms "
              f"a call | plain {t['plain_ms']:.4f} ms | bound bytes {bound[0] * 1e3:.3f} us, "
              f"operations {bound[1] * 1e3:.3f} us | {smi}")
    assert err == 0, f"B6 != its plain version (max |difference| {err})"
    print(f"phase parallel: B6 == its plain version on the card at every block of the "
          f"k = {PAR_NTT_SHARDS} shard shapes")
    del flush
    # the SASS instructions a multiply-accumulate of the hot loop of each product, in
    # the tiled kernel the k = 1 block takes (tools/ntt_sass.py --b6)
    from tools import ntt_sass
    funcs = ntt_sass.parse(ntt_sass.disassemble([ntt_sharded_cuda.BUILD_KEY],
                                                ntt_sharded_cuda.SOURCE))
    threads, _, cn = ntt_sharded_cuda.geometry(R, C, C)[:3]
    b6_name = f"tiled_kernel<{threads}, {cn}>"
    b6_sass = {step: h["instructions"] / h["macs"]
               for step, h in ntt_sass.b6_loops(b6_name, funcs[b6_name]).items()}
    print(f"phase parallel: B6 {b6_name} SASS instructions a MAC of each product's hot loop: "
          f"{', '.join(f'{st} {v:.2f}' for st, v in b6_sass.items())}")

    # -- the unsharded results on the card -------------------------------------------------
    want_ntt = rings.new_ring(n, moduli, device=dev).ntt(x).cpu()
    ctx, cts = fckks.make_synthetic_context(**PAR_FAST, device=dev)
    want_fast = [o.cpu() for o in fckks.mul_relin_rescale(ctx, *cts)]
    rolled = [torch.stack([torch.roll(v, b, dims=-1) for b in range(PAR_BATCH)]) for v in cts]
    want_batch = [[o.cpu() for o in fckks.mul_relin_rescale(ctx, *(v[b] for v in rolled))]
                  for b in range(PAR_BATCH)]
    live = PAR_FAST["num_q"] - PAR_FAST["rescale_limbs"]
    del ctx, cts, rolled
    pk_params = ckks.new_parameters(ckks.CKKSParametersLiteral(**PAR_PK_LITERAL), dev)
    samples = mpm.sample_collective_pk_over_mesh(pk_params, PAR_PK_PARTIES, _gen(2601))
    crp = protocols.sample_crp_qp(_gen(2602), pk_params)
    sks = [K.secret_key_from_sample(pk_params, s.secret) for s in samples]
    shares = [protocols.PublicKeyGen.share_from_sample(pk_params, sk, crp, s.noise)
              for sk, s in zip(sks, samples)]
    want_pk = {}
    for parties in (1, PAR_PK_PARTIES):
        agg = shares[0]
        for sh_ in shares[1:parties]:
            agg = protocols.PublicKeyGen.aggregate(pk_params, agg, sh_)
        want_pk[parties] = protocols.PublicKeyGen.finalize(pk_params, agg, crp)
    samples_np = [(s.secret.cpu().numpy(), s.noise.cpu().numpy()) for s in samples]
    crp_np = (crp.q.cpu().numpy(), crp.p.cpu().numpy())

    # -- the worlds of ranks on the card: 8 ranks over gloo (the 2-rank NTT and the 4-rank
    # step as 2-D meshes of them), then 1 rank over NCCL -----------------------------------
    ntt_cases = {8: {"n": n, "moduli": moduli, "x": x_cpu.numpy()},
                 2: {"n": n, "moduli": moduli, "x": x_cpu.numpy(), "axes": {"rep": 4, "seq": 2}}}
    fast_cases = {(8, 0): dict(PAR_FAST, batch=0), (8, PAR_BATCH): dict(PAR_FAST, batch=PAR_BATCH),
                  (4, 2): dict(PAR_FAST, batch=2, axes={"batch": 2, "limb": 4})}
    worlds = {8: (ntt_cases, fast_cases, PAR_PK_PARTIES),
              1: ({1: dict(ntt_cases[8])}, {(1, 0): fast_cases[8, 0]}, 1)}
    launches = {}
    by_path = {d: {} for d in ("fwd", "bwd", "ntt64_fwd", "ntt64_bwd")}
    shapes = {"b1": set(), "b4": set(), "b6": set()}
    on_card = dev.type == "cuda"

    def path(label, per_rank):
        """Each rank's B1 and B4 launches in one sharded call, summed into by_path, and
        the shapes it gave B1, B4 and B6."""
        for kind, name in (("b1_fwd", "fwd"), ("b1_bwd", "bwd"), ("b4_fwd", "ntt64_fwd"),
                           ("b4_bwd", "ntt64_bwd")):
            total = sum(r["counts"][kind] for r in per_rank)
            if total:
                by_path[name][label] = total
        for r in per_rank:
            for kind in shapes:
                shapes[kind].update(r["shapes"][kind])

    for world, (ncs, fcs, parties) in worlds.items():
        t0 = time.time()
        res = launch.run(world26, world, list(ncs.values()), list(fcs.values()),
                         (PAR_PK_LITERAL, samples_np[:parties], crp_np), PAR_REPEATS, dev.type,
                         device=dev, timeout=600)
        t1 = time.time()
        print(f"phase parallel: a world of {world} rank(s) ({res[0]['ntt'][0]['transport']}) took "
              f"{t1 - t0:.2f} s of wall time: the ranks' bodies began "
              f"{min(r['epoch'][0] for r in res) - t0:.2f}-{max(r['epoch'][0] for r in res) - t0:.2f}"
              f" s after the launch (spawn, imports, the process group) and ended "
              f"{t1 - max(r['epoch'][1] for r in res):.2f} s before it returned; in rank 0: "
              + ", ".join(f"{k} {v:.2f} s" for k, v in res[0]["marks"].items()))
        for i, k in enumerate(ncs):
            blocks = _select([r["ntt"][i] for r in res], rep=0) if k == 2 else \
                [r["ntt"][i] for r in res]
            got = sh.gather_columns([torch.from_numpy(b["out"]) for b in blocks], tabs)
            assert len(blocks) == k and torch.equal(got, want_ntt), \
                f"phase 26: the sharded NTT on {k} ranks != B4"
            for r in res:
                c_ = r["ntt"][i]["counts"]
                assert (c_["all_to_all"], c_["all_gather"], c_["psum"]) == (1, 0, 0), c_
                assert c_["b6"] == on_card, c_  # the plain version on the CPU
            launches[f"sharded NTT, {k} ranks (phase 26)"] = sum(b["counts"]["b6"] for b in blocks)
            path(f"sharded NTT, {k} ranks (phase 26)", [r["ntt"][i] for r in res])
            print(f"phase parallel: ntt_sharded over {k} ranks (a mesh of "
                  f"{_mesh_label([r['ntt'][i] for r in res])}) == B4's Ring.ntt, 1 all-to-all a "
                  f"rank, B6 launches {[b['counts']['b6'] for b in blocks]}, "
                  f"{_world_ms(blocks):.3f} ms a call | {smi}")
        for i, ((k, batch), case) in enumerate(fcs.items()):
            per_rank = [r["fast"][i] for r in res]
            if "axes" in case:  # a batch coordinate's limb shards hold its element
                groups = [(_select(per_rank, batch=b), [want_batch[b]]) for b in range(batch)]
            else:
                groups = [(per_rank, want_batch if batch else [want_fast])]
            for blocks, wants in groups:
                o0, o1 = (torch.from_numpy(np.concatenate([x_[o] for x_ in blocks], axis=-2)).reshape(
                    len(wants), -1, n) for o in ("o0", "o1"))
                assert len(blocks) == k
                for j, w in enumerate(wants):
                    assert torch.equal(o0[j, :live], w[0]) and torch.equal(o1[j, :live], w[1]), \
                        f"phase 26: the sharded step on {k} ranks, batch {batch}, element {j}"
                assert not o0[:, live:].any() and not o1[:, live:].any()
            for x_ in per_rank:
                c_ = x_["counts"]
                assert (c_["all_gather"], c_["psum"], c_["all_to_all"]) == (
                    1, PAR_FAST["rescale_limbs"], 0), c_
                assert (min(c_["b1_fwd"], c_["b1_bwd"]) > 0) == on_card, c_
            shape = ([batch] if batch else []) + [PAR_FAST["num_q"], n]
            path(f"sharded step {shape}, a mesh of {_mesh_label(per_rank)} (phase 26)", per_rank)
            print(f"phase parallel: build_sharded_step on {shape} over a mesh of "
                  f"{_mesh_label(per_rank)} == "
                  f"fckks.mul_relin_rescale, dropped limbs zero; (all-gather, psum) "
                  f"{[per_rank[0]['counts'][c] for c in ('all_gather', 'psum')]} a rank, B1 "
                  f"{per_rank[0]['counts']['b1_fwd']} + {per_rank[0]['counts']['b1_bwd']} a "
                  f"rank, {_world_ms(per_rank):.3f} ms a call | {smi}")
        want = want_pk[parties].value[0]
        for r in res:
            got_q, got_p = (torch.from_numpy(a) for a in r["pk"]["pk"])
            assert torch.equal(got_q, want.q.cpu()) and torch.equal(got_p, want.p.cpu()), \
                f"phase 26: the mesh public key of {parties} parties != sequential"
            c_ = r["pk"]["counts"]
            assert (c_["psum"], c_["all_gather"], c_["all_to_all"]) == (2, 0, 0), c_
            assert (c_["b4_fwd"] > 0) == on_card, c_
        path(f"party-axis key, {parties} ranks (phase 26)", [r["pk"] for r in res])
        print(f"phase parallel: collective_pk_over_mesh_from_samples of {parties} parties == the "
              f"sequential protocol, 2 psums a rank, B4 {res[0]['pk']['counts']['b4_fwd']} "
              f"forward a rank, {_world_ms([r['pk'] for r in res]):.3f} ms a call | {smi}")
    print(f"phase parallel: each call's time is the median of {PAR_REPEATS} after one warm "
          f"call, of the slowest rank, with the world's processes sharing one card (no scaling)")

    # the 8 parties' key encrypts under the sum of their secrets
    pk = K.PublicKey(value=(want_pk[PAR_PK_PARTIES].value[0], crp))
    rq, rp = pk_params.ring_q, pk_params.ring_p
    ideal_q, ideal_p = sks[0].value.q, sks[0].value.p
    for s in sks[1:]:
        ideal_q, ideal_p = rq.add(ideal_q, s.value.q), rp.add(ideal_p, s.value.p)
    enc = ckks.Encoder(pk_params)
    v = np.random.default_rng(SEED).uniform(-1, 1, pk_params.max_slots) + 0j
    ct = encryptor.encrypt(_gen(2603), pk_params, pk, enc.encode(v))
    dec = enc.decode(decryptor.decrypt(pk_params, K.SecretKey(value=K.QPPoly(ideal_q, ideal_p)),
                                       ct))
    st = precision.assert_precision(v, dec, PAR_PK_FLOOR)
    print(f"phase parallel: a vector of {len(v)} slots encrypted under the 8 parties' key "
          f"decrypts under the sum of their secrets to min {st.min_precision:.4f} bits, mean "
          f"{st.avg_precision:.4f} (floor {PAR_PK_FLOOR}: tests/test_multiparty_mesh.py:50-63)")

    # every shape the ranks gave B6, B1 and B4, held against its plain version on the card
    unheld = shapes["b6"] - b6_held
    assert not unheld, f"phase 26: B6 ran at blocks not held to its plain version: {unheld}"
    print(f"phase parallel: the ranks gave B6 {len(shapes['b6'])} blocks (shape, first column),"
          f" each among those held above")
    b1_tabs, b4_rings = {}, {}
    b1_rows = check_ntt_shapes({key: b1_tabs.setdefault(
        (key[1][-1], key[2]), ntt_cuda.build_tables(key[1][-1], list(key[2]), dev))
        for key in shapes["b1"]}, dev, rng)
    for d, shape, c, err_, ms in b1_rows:
        assert err_ == 0, f"phase 26: B1 {d} {shape}: kernel != plain ({err_})"
    b4_rows = check_b4_shapes({key: b4_rings.setdefault(
        (key[1][-1], key[2]), rings.new_ring(key[1][-1], list(key[2]), device=dev))
        for key in shapes["b4"]}, dev, rng)
    for d, shape, c, err_, _ in b4_rows:
        assert err_ == 0, f"phase 26: B4 {d} {shape}: kernel != plain ({err_})"
    for name, rows in (("B1", b1_rows), ("B4", b4_rows)):
        merged = sorted({(d, shape) for d, shape, *_ in rows}, key=lambda k_: (k_[1], k_[0]))
        print(f"phase parallel: {name} at the {len(rows)} (direction, shape, moduli) the ranks "
              f"gave it: kernel == plain at every one; the shapes: "
              + ", ".join(f"{d} {list(shape)}" for d, shape in merged))
    t8, bound8 = b6[PAR_NTT_SHARDS[0]]
    clock.done(26)
    return {"b6": {"name": "ntt_sharded_local", "route": "cuda", "source": B6_SOURCE,
                   "replaces": B6_REPLACES,
                   "launches": launches[f"sharded NTT, {PAR_NTT_SHARDS[0]} ranks (phase 26)"],
                   "max_abs_err": err, "ms": t8["ms"], "plain_ms": t8["plain_ms"],
                   **_bound_entry([bound8]), "device_ms": t8["device"],
                   "flushed_ms": t8["flushed"], "host_ms": t8["host"], "library_ms": None,
                   "sass_instructions_a_mac": b6_sass, "launches_by_path": launches},
            "by_path": by_path, "b1_rows": b1_rows, "b4_rows": b4_rows}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 1
    refs = CPUReferences()
    torch.set_num_threads(MAIN_THREADS)
    try:
        return run(refs)
    finally:
        refs.close()


def run(refs: CPUReferences) -> int:
    """Phases 1-29 on the card; ``refs``: the CPU references."""
    from matrix_fhe_tpu_torch.fast import fckks, fring
    from matrix_fhe_tpu_torch.ops import ntt_cuda, ntt_plain, ntt_w22

    # -- 1. device ------------------------------------------------------------
    clock = PhaseClock()
    smi = card_label()
    print(smi)
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {kind}")

    clock.done(1)

    # -- 2. build -------------------------------------------------------------
    from matrix_fhe_tpu_torch.ops import ntt64_cuda
    t0 = time.perf_counter()
    from matrix_fhe_tpu_torch.ops import ntt3n_cuda, ntt_sharded_cuda
    built = ntt_cuda.build_all([(ntt_cuda.SOURCE, logn) for logn in PATH_LOGNS]
                               + [(ntt64_cuda.SOURCE, logn) for logn in sorted(
                                   set(B4_SIZES) | set(RS_LOGNS) | set(EXAMPLE_LOGNS)
                                   | {BR_RING[0], BR_LWE[0]})]
                               + [(ntt3n_cuda.SOURCE, ntt3n_cuda.BUILD_KEY),
                                  (ntt_sharded_cuda.SOURCE, ntt_sharded_cuda.BUILD_KEY)])
    print(f"phase build: built {len(built)} libraries, "
          f"{', '.join(ntt_cuda.library_path(logn, src).name for src, logn in built)}, in "
          f"{time.perf_counter() - t0:.2f} s (one nvcc each, started together)")

    clock.done(2)

    # -- 3. kernel vs plain at the step's NTT shapes ----------------------------
    n = 1 << LOGN
    moduli = fring.find_fast_primes(n, NUM_Q + NUM_P)
    Q, P = moduli[:NUM_Q], moduli[NUM_Q:]
    shapes = [("rescale INTT", (NUM_Q,), Q), ("rescale NTT", (NUM_Q - 2,), Q[:-2]),
              ("decompose NTT q", (7, NUM_Q), Q), ("decompose NTT p", (7, NUM_P), P),
              ("mod_down INTT", (2, NUM_P), P), ("mod_down NTT", (2, NUM_Q), Q)]
    rng = np.random.default_rng(SEED)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    # per direction: max |kernel - plain| and the summed times over the shapes
    stats = {d: {"max_abs_err": 0, "ms": 0.0, "plain_ms": 0.0} for d in ("fwd", "bwd")}
    # per direction, summed over the shapes: device time queued back to
    # back, with L2 flushed, and the wrapper's host time a call
    extra = {d: {"device": 0.0, "flushed": 0.0, "host": 0.0} for d in ("fwd", "bwd")}
    for what, lead, mods in shapes:
        tab_cpu = ntt_cuda.build_tables(n, mods, "cpu")
        tab_dev = ntt_cuda.build_tables(n, mods, dev)
        hi = np.array(mods, dtype=np.int64)[:, None]
        x_cpu = torch.from_numpy(
            (rng.integers(0, 1 << 62, lead + (n,)) % hi).astype(np.int32))
        x = x_cpu.to(dev)
        f, b = ntt_cuda.ntt_fwd(x, tab_dev), ntt_cuda.ntt_bwd(x, tab_dev)
        rt = ntt_cuda.ntt_bwd(f, tab_dev)
        torch.cuda.synchronize()
        want_f = ntt_plain.ntt_fwd_plain(x_cpu, tab_cpu)
        want_b = ntt_plain.ntt_bwd_plain(x_cpu, tab_cpu)
        err = {"fwd": int((f.cpu().long() - want_f.long()).abs().max()),
               "bwd": int((b.cpu().long() - want_b.long()).abs().max())}
        assert err == {"fwd": 0, "bwd": 0}, f"{what} {lead}: kernel != plain {err}"
        assert torch.equal(rt.cpu(), x_cpu), f"{what}: inverse(forward(x)) != x"
        # the plain version on the card computes the same (float64 matmuls)
        assert torch.equal(ntt_plain.ntt_fwd_plain(x, tab_dev).cpu(), want_f)
        assert torch.equal(ntt_plain.ntt_bwd_plain(x, tab_dev).cpu(), want_b)
        k_f = _event_ms(lambda: ntt_cuda.ntt_fwd(x, tab_dev))
        k_b = _event_ms(lambda: ntt_cuda.ntt_bwd(x, tab_dev))
        p_f = _event_ms(lambda: ntt_plain.ntt_fwd_plain(x, tab_dev))
        p_b = _event_ms(lambda: ntt_plain.ntt_bwd_plain(x, tab_dev))
        for d, k, p in (("fwd", k_f, p_f), ("bwd", k_b, p_b)):
            stats[d]["max_abs_err"] = max(stats[d]["max_abs_err"], err[d])
            stats[d]["ms"] += k
            stats[d]["plain_ms"] += p
        c = ntt_cuda.geometry(int(np.prod(lead)), n, 1, sms)
        more = {}
        for d, kern in (("fwd", ntt_cuda.ntt_fwd), ("bwd", ntt_cuda.ntt_bwd)):
            more[d] = {"device": _device_ms(lambda: kern(x, tab_dev)),
                       "flushed": _flushed_ms(lambda: kern(x, tab_dev), flush),
                       "host": _host_ms(lambda: kern(x, tab_dev))}
            for key, v in more[d].items():
                extra[d][key] += v
        print(f"phase kernel: {what:16s} {str(list(lead) + [n]):14s} C={c} "
              f"kernel fwd {k_f:.4f} ms bwd {k_b:.4f} ms | "
              f"plain fwd {p_f:.4f} ms bwd {p_b:.4f} ms | bit-identical")
        print("phase kernel:   fwd / bwd: device time queued {:.4f} / {:.4f} ms, "
              "L2 flushed {:.4f} / {:.4f} ms, wrapper host time {:.4f} / {:.4f} ms "
              "a call".format(*(more[d][key] for key in ("device", "flushed", "host")
                                for d in ("fwd", "bwd"))))
    print("phase kernel: six shapes summed, fwd / bwd: kernel {:.4f} / {:.4f} ms, "
          "device time queued {:.4f} / {:.4f} ms, L2 flushed {:.4f} / {:.4f} ms, "
          "wrapper host time {:.4f} / {:.4f} ms".format(
              stats["fwd"]["ms"], stats["bwd"]["ms"],
              *(extra[d][key] for key in ("device", "flushed", "host")
                for d in ("fwd", "bwd"))))
    del flush

    clock.done(3)

    # -- 4. main path: three requests ------------------------------------------
    ctx, ops = fckks.make_synthetic_context(
        LOGN, NUM_Q, NUM_P, seed=SEED, num_rot=NUM_ROT, device=dev)
    ref_ctx, ref_ops = fckks.make_synthetic_context(
        LOGN, NUM_Q, NUM_P, seed=SEED, num_rot=NUM_ROT, device="cpu")
    orders = [(0, 1, 2, 3), (2, 3, 0, 1), (1, 0, 3, 2)]  # operands per request
    # NTT launches per request.  mul_relin_rescale: decompose_ks 1 INTT +
    # 2 NTT, mod_down 1 + 1, two rescales 1 + 1 each.  rotations_hoisted over
    # G elements: decompose_ks 1 INTT + 2 NTT, then mod_down 1 + 1 per element.
    G = len(ctx.gal_els)
    per_request = {"fwd": 5 + 2 + G, "bwd": 4 + 1 + G}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ntt_cuda.fwd_launches = ntt_cuda.bwd_launches = ntt_cuda.launches = 0
    outs, lat = [], []
    for r, order in enumerate(orders):
        a = [ops[i] for i in order]
        t0 = time.perf_counter()
        step = fckks.mul_relin_rescale(ctx, *a)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        rots = fckks.rotations_hoisted(ctx, a[0], a[1], ctx.gal_els)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        outs.append((step, rots))
        lat.append(((t1 - t0) * 1e3, (t2 - t1) * 1e3))
        counts = {"fwd": ntt_cuda.fwd_launches, "bwd": ntt_cuda.bwd_launches}
        want = {d: c * (r + 1) for d, c in per_request.items()}
        assert counts == want, f"request {r}: NTT launches {counts}, expected {want}"
    launches = {"fwd": ntt_cuda.fwd_launches, "bwd": ntt_cuda.bwd_launches}
    assert ntt_cuda.launches == sum(launches.values())
    peak = torch.cuda.max_memory_allocated()
    for r, (m, rot) in enumerate(lat):
        print(f"phase main: request {r}: mul_relin_rescale {m:.3f} ms, "
              f"rotations_hoisted x{len(ctx.gal_els)} {rot:.3f} ms")
    print(f"phase main: NTT kernel launches {launches} ({per_request} per request), "
          f"peak device memory {peak / 2**20:.1f} MiB")

    # steady state: the same request repeated, host clock around a sync
    reps = {"mul_relin_rescale": [], "rotations_hoisted": []}
    for _ in range(10):
        t0 = time.perf_counter()
        fckks.mul_relin_rescale(ctx, *ops)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        fckks.rotations_hoisted(ctx, ops[0], ops[1], ctx.gal_els)
        torch.cuda.synchronize()
        reps["mul_relin_rescale"].append((t1 - t0) * 1e3)
        reps["rotations_hoisted"].append((time.perf_counter() - t1) * 1e3)
    for k, v in reps.items():
        print(f"phase main: steady {k}: median {statistics.median(v):.3f} ms "
              f"(min {min(v):.3f}, max {max(v):.3f}, 10 runs)")

    # -- checks ---------------------------------------------------------------
    (o0, o1), rots = outs[0]
    assert _digest([o0, o1]) == MUL_RELIN_RESCALE_SHA256, "mul_relin_rescale digest"
    assert _digest([t for g in ctx.gal_els for t in rots[g]]) == \
        ROTATIONS_HOISTED_SHA256, "rotations_hoisted digest"
    q_out = torch.tensor(Q[: NUM_Q - 2], dtype=torch.int32, device=dev)[:, None]
    for r, ((o0, o1), rots) in enumerate(outs):
        a = [ref_ops[i] for i in orders[r]]
        w0, w1 = fckks.mul_relin_rescale(ref_ctx, *a)
        assert o0.shape == o1.shape == (NUM_Q - 2, n)
        assert bool(((o0 >= 0) & (o0 < q_out)).all()) and bool(((o1 >= 0) & (o1 < q_out)).all())
        assert torch.equal(o0.cpu(), w0) and torch.equal(o1.cpu(), w1), \
            f"request {r}: mul_relin_rescale on the card != CPU plain path"
        want = fckks.rotations_hoisted(ref_ctx, a[0], a[1], ref_ctx.gal_els)
        for g in ctx.gal_els:
            assert torch.equal(rots[g][0].cpu(), want[g][0]) and \
                torch.equal(rots[g][1].cpu(), want[g][1]), \
                f"request {r}: rotation {g} on the card != CPU plain path"
    print("phase check: digests equal the JAX package's; all requests equal "
          "the CPU plain path")

    max_sm_mhz, int32_ops_per_s = int32_rate(sms)
    print(f"bound: {HBM_BYTES_PER_S / 1e12} TB/s, {sms} SMs x "
          f"{INT32_OPS_PER_CLOCK_PER_SM} int32 op/clock at {max_sm_mhz} MHz = "
          f"{int32_ops_per_s / 1e12:.3f} Tops/s")
    step_bounds = [_bound(int(np.prod(lead)), len(mods), n, 1, int32_ops_per_s)
                   for _, lead, mods in shapes]
    for (what, lead, _), (b_ms, o_ms) in zip(shapes, step_bounds):
        print(f"bound: {what:16s} {str(list(lead) + [n]):14s} bytes {b_ms * 1e3:.3f} us, "
              f"operations {o_ms * 1e3:.3f} us")
    for d in ("fwd", "bwd"):
        stats[d].update(_bound_entry(step_bounds))

    clock.done(4)

    # -- 5. chain kernel vs plain ----------------------------------------------
    moduli = ntt_cuda.find_v2_primes(n, BENCH_LIMBS)
    tab_cpu = ntt_cuda.build_tables(n, moduli[:3], "cpu")
    tab_dev = ntt_cuda.build_tables(n, moduli[:3], dev)
    x_cpu = _operands(rng, (8, 3, n), moduli[:3])
    x = x_cpu.to(dev)
    for fwd, d in ((True, "chain_fwd"), (False, "chain_bwd")):
        got = ntt_cuda.ntt_chain(x, tab_dev, 3, fwd=fwd)
        torch.cuda.synchronize()
        want = ntt_plain.ntt_chain_plain(x_cpu, tab_cpu, 3, fwd)
        err = int((got.cpu().long() - want.long()).abs().max())
        assert err == 0, f"chain {d} [8, 3, N] k=3: kernel != plain ({err})"
        if fwd:
            back = ntt_cuda.ntt_chain(got, tab_dev, 3, fwd=False)
            assert torch.equal(back.cpu(), x_cpu), "inverse-chain(forward-chain(x)) != x"
        k_ms = _event_ms(lambda: ntt_cuda.ntt_chain(x, tab_dev, 3, fwd=fwd))
        p_ms = _event_ms(lambda: ntt_plain.ntt_chain_plain(x, tab_dev, 3, fwd))
        stats[d] = {"max_abs_err": err}
        print(f"phase chain: {d:9s} [8, 3, {n}] k=3 kernel {k_ms:.4f} ms | "
              f"plain {p_ms:.4f} ms | bit-identical")

    clock.done(5)

    # -- 6. NTT path at bench width --------------------------------------------
    tabs = ntt_cuda.build_tables(n, moduli, dev)
    brng = np.random.default_rng(0)  # bench.py:70-74, in its order
    xb = torch.from_numpy(brng.integers(
        0, min(moduli), (CHAIN_BATCH, BENCH_LIMBS, n), dtype=np.int64).astype(np.int32)).to(dev)
    xd = torch.from_numpy(brng.integers(
        0, min(moduli), (DISPATCH_BATCH, BENCH_LIMBS, n), dtype=np.int64).astype(np.int32)).to(dev)
    torch.cuda.synchronize()
    for name in ("fwd_launches", "bwd_launches", "chain_fwd_launches",
                 "chain_bwd_launches", "launches"):
        setattr(ntt_cuda, name, 0)
    f = ntt_cuda.ntt_chain(xb, tabs, CHAIN_K, fwd=True)
    back = ntt_cuda.ntt_chain(f, tabs, CHAIN_K, fwd=False)
    fd = ntt_cuda.ntt_fwd(xd, tabs)
    torch.cuda.synchronize()
    path = {"chain_fwd": ntt_cuda.chain_fwd_launches,
            "chain_bwd": ntt_cuda.chain_bwd_launches, "dispatch": ntt_cuda.fwd_launches}
    assert path == {"chain_fwd": 1, "chain_bwd": 1, "dispatch": 1} and \
        ntt_cuda.launches == 3, f"NTT path launches {path}"
    assert torch.equal(back, xb), "500-step inverse chain of the forward chain != x"
    seq = xb
    for _ in range(CHAIN_K):
        seq = ntt_cuda.ntt_fwd(seq, tabs)
    assert torch.equal(f, seq), "chain != 500 sequential ntt_fwd launches"
    # the plain version on the card equals the CPU's (phase 3)
    assert torch.equal(fd, ntt_plain.ntt_fwd_plain(xd, tabs)), "dispatch form: kernel != plain"
    for fwd, d in ((True, "chain_fwd"), (False, "chain_bwd")):
        got = f if fwd else ntt_cuda.ntt_chain(xb, tabs, CHAIN_K, fwd=False)
        want = ntt_plain.ntt_chain_plain(xb, tabs, CHAIN_K, fwd)
        err = int((got.long() - want.long()).abs().max())
        assert err == 0, f"{d} at bench width: kernel != plain ({err})"
        stats[d]["max_abs_err"] = max(stats[d]["max_abs_err"], err)
        stats[d]["ms"] = _event_ms(
            lambda: ntt_cuda.ntt_chain(xb, tabs, CHAIN_K, fwd=fwd), iters=5, warmup=1)
        stats[d]["plain_ms"] = _event_ms(
            lambda: ntt_plain.ntt_chain_plain(xb, tabs, CHAIN_K, fwd), iters=2, warmup=0)
        stats[d].update(_bound_entry(
            [_bound(CHAIN_BATCH * BENCH_LIMBS, BENCH_LIMBS, n, CHAIN_K, int32_ops_per_s)]))
        rate = CHAIN_BATCH * BENCH_LIMBS * CHAIN_K / (stats[d]["ms"] / 1e3)
        print(f"phase ntt path: {d:9s} [{CHAIN_BATCH}, {BENCH_LIMBS}, {n}] k={CHAIN_K} "
              f"kernel {stats[d]['ms']:.3f} ms ({stats[d]['ms'] / CHAIN_K * 1e3:.3f} us a "
              f"step, {rate:.0f} NTT/s) | plain {stats[d]['plain_ms']:.1f} ms | "
              f"bound {stats[d]['bound_ms']:.3f} ms by {stats[d]['bound_by']} | {smi}")
    from tools import ntt_sass
    funcs = ntt_sass.parse(ntt_sass.disassemble([LOGN]))
    regs = ntt_sass.ptxas_report(ntt_sass.build_logs([LOGN]))
    for d in ("fwd", "bwd"):
        name = f"ntt_{d}_kernel<{LOGN}, 1>"
        instrs, flies = ntt_sass.hot_pass(funcs[name])
        assert flies == 32, f"{name}: hot pass of {flies} butterflies"
        step_us = stats[f"chain_{d}"]["ms"] / CHAIN_K * 1e3
        print(f"phase ntt path: {name} hot pass {instrs} instructions / {flies} "
              f"butterflies = {instrs / flies:.2f} a butterfly; {regs[name]['registers']} "
              f"registers, {regs[name]['spill_bytes']} spill bytes; {step_us:.3f} us a step")
    d_ms = _event_ms(lambda: ntt_cuda.ntt_fwd(xd, tabs))
    d_dev = _device_ms(lambda: ntt_cuda.ntt_fwd(xd, tabs))
    d_bytes, d_ops = _bound(DISPATCH_BATCH * BENCH_LIMBS, BENCH_LIMBS, n, 1, int32_ops_per_s)
    print(f"phase ntt path: dispatch  [{DISPATCH_BATCH}, {BENCH_LIMBS}, {n}] ntt_fwd "
          f"{d_ms:.4f} ms a launch ({DISPATCH_BATCH * BENCH_LIMBS / (d_ms / 1e3):.0f} NTT/s; "
          f"device time queued {d_dev:.4f} ms) | "
          f"bound {max(d_bytes, d_ops):.4f} ms by "
          f"{'operations' if d_ops >= d_bytes else 'bytes'} | {smi}")
    print(f"phase ntt path: launches {path}; forward chain == {CHAIN_K} sequential "
          f"ntt_fwd launches == plain; inverse chain returns x")

    clock.done(6)

    # -- 7. w22 transform ---------------------------------------------------------
    w22_path, w22_shape = {}, W22_SHAPES[0]
    for shape in W22_SHAPES:
        wn = shape[-1]
        mods = ntt_w22.find_w22_primes(wn, shape[-2])
        wt_cpu = ntt_w22.build_tables(wn, mods, "cpu")
        wt_dev = ntt_w22.build_tables(wn, mods, dev)
        x_cpu = _operands(rng, shape, mods)
        x = x_cpu.to(dev)
        if shape == w22_shape:
            torch.cuda.synchronize()
            ntt_w22.w22_fwd_launches = ntt_w22.w22_bwd_launches = 0
            rt = ntt_w22.ntt_bwd(ntt_w22.ntt_fwd(x, wt_dev), wt_dev)
            torch.cuda.synchronize()
            w22_path = {"w22_fwd": ntt_w22.w22_fwd_launches,
                        "w22_bwd": ntt_w22.w22_bwd_launches}
            assert w22_path == {"w22_fwd": 1, "w22_bwd": 1}, f"w22 launches {w22_path}"
            assert torch.equal(rt, x), "w22: inverse(forward(x)) != x"
        line = []
        for fwd, d in ((True, "w22_fwd"), (False, "w22_bwd")):
            kern = ntt_w22.ntt_fwd if fwd else ntt_w22.ntt_bwd
            plain = ntt_plain.ntt_fwd_plain if fwd else ntt_plain.ntt_bwd_plain
            got = kern(x, wt_dev)
            torch.cuda.synchronize()
            err = int((got.cpu().long() - plain(x_cpu, wt_cpu).long()).abs().max())
            assert err == 0, f"{d} {shape}: kernel != plain ({err})"
            k_ms = _event_ms(lambda: kern(x, wt_dev))
            dev_ms = _device_ms(lambda: kern(x, wt_dev))
            p_ms = _event_ms(lambda: plain(x, wt_dev))
            entry = stats.setdefault(d, {"max_abs_err": 0})
            entry["max_abs_err"] = max(entry["max_abs_err"], err)
            if shape == w22_shape:
                entry.update(ms=k_ms, plain_ms=p_ms, **_bound_entry(
                    [_bound(shape[0] * shape[1], shape[1], wn, 1, int32_ops_per_s)]))
            line.append(f"{d} kernel {k_ms:.4f} ms (device time queued {dev_ms:.4f} ms) "
                        f"plain {p_ms:.4f} ms")
        print(f"phase w22: {list(shape)} " + " | ".join(line) + " | bit-identical")
    print(f"phase w22: launches {w22_path}; inverse(forward(x)) == x")

    clock.done(7)

    # -- 8. the real-key CKKS session at the bench shape --------------------------
    check_int64_wrap(dev)
    print("phase session: int64 * + - >> wrap and shift on the card as on the CPU")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()  # by the earlier phases
    params = session_params(dev)
    times: dict = {}
    b4_calls: dict = {}   # B4's calls and launches by shape, phases 8-13 (cold passes)
    b4_launches: dict = {}
    (sk, rlk, gks), b4_keygen = _b4_counted(dev, lambda: b4_shapes(
        lambda: session_keys(params, SESSION_ROTATIONS, times), b4_calls, b4_launches))
    out, b4_session = _b4_counted(dev, lambda: b4_shapes(
        lambda: session_run(params, sk, rlk, gks, SESSION_ROTATIONS, times), b4_calls,
        b4_launches))
    peak = torch.cuda.max_memory_allocated()
    # the warm pass: the same session again, every context and block made
    warm_times: dict = {}
    warm_keys = session_keys(params, SESSION_ROTATIONS, warm_times)
    warm = session_run(params, *warm_keys, SESSION_ROTATIONS, warm_times)
    assert _same(warm_keys, (sk, rlk, gks)), "session keys: warm pass != cold pass"
    for what in ("cts", "prod", "rots", "dec_prod", "dec_rots", "counts"):
        assert _same(warm[what], out[what]), f"session {what}: warm pass != cold pass"
    for what, c in out["counts"].items():
        assert c == SESSION_LAUNCHES[what], \
            f"session {what}: B1 launches {c}, expected {SESSION_LAUNCHES[what]}"
    for name, ms in times.items():
        print(f"phase session: {name:24s} cold {ms:10.3f} ms, warm {warm_times[name]:10.3f} ms"
              f" | {smi}")
    print(f"phase session: peak device memory {(peak - held) / 2**20:.1f} MiB above the "
          f"{held / 2**20:.1f} MiB the earlier phases hold ({peak / 2**20:.1f} MiB in all) | {smi}")
    print(f"phase session: B1 launches {out['counts']}; B4 launches (the u64 NTT) keygen "
          f"{b4_keygen}, encode to decode {b4_session}")
    for what, floor in PRECISION_FLOOR.items():
        got = out["precision"][what]
        print(f"phase session: min precision {what} {got:.4f} bits (floor {floor:.4f})")
        assert got >= floor, f"session {what}: {got:.4f} bits below the floor {floor:.4f}"
    # the FastEvaluator's product equals the fast step on make_context's keys
    from matrix_fhe_tpu_torch.fast import fckks
    ctx2 = fckks.make_context(params, rlk, rescale_limbs=2)
    (c0, c1), (d0, d1) = (ct.value for ct in out["cts"])
    step = fckks.mul_relin_rescale(ctx2, c0, c1, d0, d1)
    assert _same(tuple(out["prod"].value), step), "FastEvaluator product != mul_relin_rescale"
    # the card's keys and outputs equal the same code on the CPU
    cpu_params = session_params(torch.device("cpu"))
    cpu_times: dict = {}
    csk, crlk, cgks = session_keys(cpu_params, CPU_GALOIS, cpu_times)
    assert _same(sk, csk) and _same(rlk, crlk), "secret / relinearization key: card != CPU"
    assert _same({g: gks[g] for g in cgks}, cgks), "galois keys: card != CPU"
    ref = session_run(cpu_params, csk, crlk, {g: _to_cpu(k) for g, k in gks.items()},
                      SESSION_ROTATIONS, cpu_times)
    for what in ("cts", "prod", "rots", "dec_prod", "dec_rots"):
        assert _same(out[what], ref[what]), f"session {what}: card != CPU"
    for name, ms in cpu_times.items():
        print(f"phase session: CPU reference {name:24s} {ms:10.3f} ms")
    print(f"phase session: card == CPU for the secret and relinearization keys, the galois "
          f"keys of rotations {CPU_GALOIS}, both ciphertexts, the product, the "
          f"{len(SESSION_ROTATIONS)} rotations and their decodings; FastEvaluator product "
          f"== fckks.mul_relin_rescale; CPU reference {sum(cpu_times.values()) / 1e3:.1f} s")

    session8 = {"params": params, "sk": sk, "gks": gks}   # for phase 29
    clock.done(8)

    # -- 9. bootstrapping at logN = 14 ----------------------------------------------
    from matrix_fhe_tpu_torch.circuits.ckks import bootstrapping as btp
    from matrix_fhe_tpu_torch.fast import fboot
    from matrix_fhe_tpu_torch.schemes import ckks
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    bp = btp.Parameters(fboot.FAST_N14, device=dev)
    bparams = bp.params
    print(f"phase boot: FAST_N14, logN {bparams.log_n}, {len(bparams.q)} + {len(bparams.p)} "
          f"primes < 2^23, {bparams.max_slots} slots, residual level {bp.residual_level}, "
          f"{len(bp.galois_elements())} galois keys, sparse secret weight "
          f"{bp.lit.ephemeral_secret_weight}")
    btimes: dict = {}
    (bsk, bevk), b4_bkeys = _b4_counted(dev, lambda: b4_shapes(
        lambda: boot_keys(bp, btimes), b4_calls, b4_launches))
    boot, b4_bsession = _b4_counted(dev, lambda: b4_shapes(
        lambda: boot_session(bp, bsk, bevk, btimes), b4_calls, b4_launches))
    bpeak = torch.cuda.max_memory_allocated()
    bwarm_times: dict = {}
    wkeys = boot_keys(bp, bwarm_times)
    bwarm = boot_session(bp, *wkeys, bwarm_times, repeats=BOOT_REPEATS)
    assert _same(wkeys, (bsk, bevk)), "bootstrap keys: warm pass != cold pass"
    for what in ("ct", "boot", "meta", "dec", "dec_meta", "counts"):
        assert _same(bwarm[what], boot[what]), f"bootstrap {what}: warm pass != cold pass"
    for what, c in boot["counts"].items():
        assert c["fwd"] > 0 and c["bwd"] > 0, f"{what}: B1 not launched ({c})"
    out_b, meta = boot["boot"], boot["meta"]
    assert out_b.level == bp.residual_level and out_b.scale == bparams.default_scale, \
        (out_b.level, out_b.scale)
    assert meta.level == bp.residual_level - 1 and meta.scale == bparams.default_scale
    for name, ms in btimes.items():
        warm_ms = bwarm_times[name]
        print(f"phase boot: {name:34s} cold {ms:10.3f} ms, warm {warm_ms:10.3f} ms | {smi}")
    print(f"phase boot: bootstrap, warm, {BOOT_REPEATS} more: "
          f"{', '.join(f'{t:.3f}' for t in bwarm['repeats'])} ms, median "
          f"{statistics.median(bwarm['repeats']):.3f} ms | {smi}")
    print(f"phase boot: peak device memory {(bpeak - held) / 2**20:.1f} MiB above the "
          f"{held / 2**20:.1f} MiB the earlier phases hold | {smi}")
    print(f"phase boot: B1 launches {boot['counts']} (cold pass == warm pass); B4 launches "
          f"(the u64 NTT) keygen {b4_bkeys}, make_fast_bootstrapper to decode {b4_bsession}")
    for what, dec in (("bootstrap", boot["dec"]), ("evaluate(iterations=2)", boot["dec_meta"])):
        st = ckks.precision_stats(boot["v"], dec)
        print(f"phase boot: decoded precision of {what}: mean {st.avg_precision:.4f} bits, "
              f"min {st.min_precision:.4f} bits over {len(dec)} slots | {smi}")

    # stage by stage: the bootstrap's own stages, decrypted after each
    rows, staged = boot_stages(boot["bts"], bsk, boot["ct"], boot["v"])
    assert _same(staged, out_b), "the stages composed != bootstrap"
    for stage, ct_s, own, total, note in rows:
        print(f"phase boot: stage {stage:13s} level {ct_s.level:2d} scale 2^"
              f"{np.log2(float(ct_s.scale)):6.2f} | own mean {own[0]:8.4f} min {own[1]:8.4f} "
              f"bits | total mean {total[0]:8.4f} min {total[1]:8.4f} bits | {note}")

    # the circuits held to the JAX package's precision
    circ = boot_circuits(boot["bts"], bsk)
    for name, st in circ.items():
        jax_mean, jax_min = BOOT_JAX_PRECISION[name]
        line = (f"phase boot: {name}: mean {st.avg_precision:.4f} bits, min "
                f"{st.min_precision:.4f} bits (JAX package on the CPU: mean {jax_mean:.4f}, "
                f"min {jax_min:.4f})")
        if name in BOOT_FLOORS:
            line += f"; floor on the mean {jax_mean - 1:.4f}"
        print(line + f" | {smi}")
        if name in BOOT_FLOORS:
            assert st.avg_precision >= jax_mean - 1, f"{name}: below the floor"

    # every shape the bootstrap gives B1: kernel == plain, and its time there
    shapes = ntt_shapes(lambda: boot["bts"].evaluate(boot["ct"], iterations=2))
    shape_rows = check_ntt_shapes(shapes, dev, rng)
    for d, shape, c, err, ms in shape_rows:
        assert err == 0, f"B1 {d} {shape}: kernel != plain ({err})"
        stats[d]["max_abs_err"] = max(stats[d]["max_abs_err"], err)
    print(f"phase boot: B1 at the {len(shape_rows)} shapes (direction, batch, limbs; each "
          f"set of moduli apart) of bootstrap and evaluate(iterations=2): kernel == plain "
          f"at every one")
    for d, shape, c, err, ms in shape_rows:
        print(f"phase boot:   {d} {str(list(shape)):17s} C={c} device time queued {ms:.4f} ms")

    # held to the same session on the CPU (a worker process, the plain NTT) after phase 25
    to_hold = {"boot": {"keys": _tree_digest((bsk, bevk)),
                     **{k: boot[k] for k in CPU_REFERENCES["boot"] if k != "keys"}}}
    boot_counts = boot["counts"]
    clock.done(9)

    # -- 27. the staged bootstrap on phase 9's session (the wide one after phase 13) --------
    staged27 = {"fast": staged_phase(
        "fast FAST_N14", dict(boot, counts={"B1": boot_counts["bootstrap"]},
                              repeats=bwarm["repeats"]), rows, bsk, 127, dev, smi)}
    del boot, bwarm
    clock.done(27)
    b4 = wide_phases(dev, smi, rng, sms, int32_ops_per_s, clock, b4_calls, b4_launches)
    to_hold.update(b4.pop("to_hold"))
    clock.done(13)
    wb = b4["wide_boot"]
    staged27["wide"] = staged_phase(f"wide wide_parameters_literal({LOGN})", wb,
                                    wb.pop("stage_rows"), wb["sk"], 227, dev, smi)
    for k in ("ct", "boot", "counts", "repeats"):
        del wb[k]
    clock.done(27)
    fork = matrix_phases(dev, smi, rng, int32_ops_per_s, clock)
    to_hold.update(fork.pop("to_hold"))
    ci29 = fork["ci_session"]   # for phase 29
    clock.done(16)
    rings = ring_phases(dev, smi, rng, int32_ops_per_s, clock, refs, b4.pop("wide_boot"),
                        fork.pop("ci_session"))
    to_hold.update(rings.pop("to_hold"))
    clock.done(20)
    rgsw_mp = rgsw_multiparty_phases(dev, smi, rng, int32_ops_per_s, clock, refs)
    clock.done(22)
    surface = surface_phases(dev, smi, rng, int32_ops_per_s, clock, refs)
    gp = graph_phase(dev, smi, {"session": session8, "matrix": fork.pop("matrix_session"),
                                "ci": ci29, "blindrot": rgsw_mp.pop("blindrot"),
                                "flagship": surface.pop("flagship")}, clock)
    del session8, ci29
    hold_to_cpu_references(to_hold, refs, clock)
    par = parallel_phase(dev, smi, rng, int32_ops_per_s, clock)
    n16 = n16_phase(dev, smi, rng, int32_ops_per_s, clock)
    assert "jax" not in sys.modules
    loss = (b4["loss"] + fork["ci_loss"] + rings["loss"] + rings["ci_loss"] + rgsw_mp["loss"]
            + surface["loss"] + surface["ci_loss"] + n16["loss"])
    print(f"phase b4 loss: B4 over phases 8-13, 16-25 and 28: {len(loss)} shapes, "
          f"{sum(r['launches'] for r in loss)} launches, loss launches x (device - bound) "
          f"{sum(r['loss_ms'] for r in loss):.4f} ms summed | {smi}")
    ntt_cuda.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    (ntt_cuda.BUILD_DIR / "b4_shapes.json").write_text(json.dumps({"device": smi, "shapes": loss}))

    by_path = {d: {"step (phase 4)": launches[d], "session (phase 8, cold pass)":
                   out["counts"]["multiply"][d] + out["counts"]["rotations"][d],
                   "bootstrap (phase 9)": boot_counts["bootstrap"][d],
                   "evaluate(iterations=2) (phase 9)": boot_counts["evaluate"][d]}
               for d in ("fwd", "bwd")}
    launches.update(chain_fwd=path["chain_fwd"], chain_bwd=path["chain_bwd"], **w22_path)
    for d in ("fwd", "bwd"):
        by_path[f"ntt64_{d}"] = {
            "session (phase 8, cold pass: keygen + encode to decode)":
                b4_keygen[d] + b4_session[d],
            "bootstrap setup (phase 9, cold pass: keygen + make_fast_bootstrapper to decode)":
                b4_bkeys[d] + b4_bsession[d],
            **{k: v[d] for k, v in b4["by_path"].items()},
            **{k: v[d] for k, v in rings["by_path"].items()},
            **{k: v[d] for k, v in rgsw_mp["by_path"].items()},
            **{k: v[d] for k, v in surface["by_path"].items()},
            **{k: v[d] for k, v in n16["by_path"].items()}}
        launches[f"ntt64_{d}"] = 3 * b4["by_path"]["wide step PN14QP438 (phase 11, a request)"][d]
        stats[f"ntt64_{d}"] = dict(b4["stats"][d], max_abs_err=max(
            [r[-1] for r in b4["size_rows"]] + [r[3] for r in b4["shape_rows"] + rings["shape_rows"]
                                                + rgsw_mp["shape_rows"] + surface["shape_rows"]
                                                + par["b4_rows"] + n16["shape_rows"]
                                                if r[0] == d]))
        REPLACES[f"ntt64_{d}"] = B4_REPLACES[d]
    for d in ("fwd", "bwd"):  # phase 27: a staged bootstrap's kernel nodes in its graphs
        by_path[d]["staged fast bootstrap (phase 27, kernel nodes a bootstrap)"] = \
            staged27["fast"]["nodes"]["B1"][d]
        for path in ("fast", "wide"):
            by_path[f"ntt64_{d}"][f"staged {path} bootstrap (phase 27, kernel nodes a "
                                  f"bootstrap)"] = staged27[path]["nodes"]["B4"][d]
    for d in ("fwd", "bwd"):  # phase 29: kernel nodes in the key-switch graphs
        for item, what in (("flagship", "flagship step + 8 rotations"),
                           ("blindrot", "a blind-rotated slot"), ("keygen", "8 galois keys")):
            by_path[f"ntt64_{d}"][f"{what} (phase 29, kernel nodes x replays in the key-switch "
                                  f"graphs a call)"] = gp[item]["in_graphs"]["B4"][d]
    for d in ("fwd", "bwd"):
        by_path[f"ntt3n_{d}"] = {k: v[d] for k, v in fork["b5_by_path"].items()}
        by_path[f"ntt3n_{d}"]["Matrix-CKKS mul_relin + rescale (phase 29, kernel nodes x "
                              f"replays in the key-switch graphs a call)"] = \
            gp["matrix"]["in_graphs"]["B5"][d]
        launches[f"ntt3n_{d}"] = fork["b5_launches"][d]
        stats[f"ntt3n_{d}"] = fork["b5_stats"][d]
        REPLACES[f"ntt3n_{d}"] = B5_REPLACES[d]
        by_path[f"ntt64_ci_{d}"] = {f"CKKS on the CI ring, {k} (phase 16)": v[d]
                                    for k, v in fork["ci_by_path"].items()}
        by_path[f"ntt64_ci_{d}"]["bridge, the CI side (phase 18)"] = rings["ci_launches"][d]
        by_path[f"ntt64_ci_{d}"]["example ckks_scheme_switching, the CI side (phase 25)"] = \
            surface["ci_launches"][d]
        by_path[f"ntt64_ci_{d}"]["CI mul_relin + rescale (phase 29, kernel nodes x replays in "
                                 f"the key-switch graphs a call)"] = gp["ci"]["in_graphs"]["B4"][d]
        launches[f"ntt64_ci_{d}"] = fork["ci_launches"][d]
        stats[f"ntt64_ci_{d}"] = dict(fork["ci_stats"][d], max_abs_err=max(
            [fork["ci_stats"][d]["max_abs_err"]] + [r[2] for r in rings["ci_rows"] + surface["ci_rows"]
                                                     if r[0] == d]))
        REPLACES[f"ntt64_ci_{d}"] = CI_REPLACES[d]
    for d, paths in par["by_path"].items():  # phase 26's ranks
        by_path[d].update(paths)
    for d, _, _, err_, _ in par["b1_rows"]:
        stats[d]["max_abs_err"] = max(stats[d]["max_abs_err"], err_)
    kernels = []
    for d in ("fwd", "bwd", "chain_fwd", "chain_bwd", "w22_fwd", "w22_bwd", "ntt64_fwd",
              "ntt64_bwd", "ntt3n_fwd", "ntt3n_bwd", "ntt64_ci_fwd", "ntt64_ci_bwd"):
        source = {"ntt64": B4_SOURCE, "ntt3n": B5_SOURCE}.get(d[:5], SOURCE)
        entry = {"name": d if d[:5] in ("ntt64", "ntt3n") else f"ntt_{d}", "route": "cuda",
                 "source": source, "replaces": REPLACES[d], "launches": launches[d],
                 **stats[d], "library_ms": None}
        if d in by_path:
            entry["launches_by_path"] = by_path[d]
        assert entry["launches"] > 0 and entry["max_abs_err"] == 0, entry
        kernels.append(entry)
    assert par["b6"]["launches"] > 0 and par["b6"]["max_abs_err"] == 0, par["b6"]
    kernels.append(par["b6"])
    clock.done(28)
    for n in range(1, 30):
        print(f"phase time: {n} {clock.times.get(n, 0.0):.3f}")
    print(f"phase time: all {sum(clock.times.values()):.3f}")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
