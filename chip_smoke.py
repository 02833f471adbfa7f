"""Smoke run of the PyTorch port on one NVIDIA H100: build, check, solve.

    python3 chip_smoke.py

Runs from the root of a checkout and needs one CUDA card of compute
capability 9.0 (Hopper) and ``nvcc``. It imports nothing of JAX. Phases:

1. the card (``nvidia-smi``) and the torch / CUDA versions;
2. the build of ``gqmap_tpu_torch/csrc/*.cu`` with its time, each source's
   ``nvcc`` time and the ptxas report; a second build must be a cache hit;
   the SASS of the library (``cuobjdump -sass``): the instructions of K1's
   float32 inner loops per mode (recur and exp) and of the whole float32
   function of K2's and K3's main-path instance per quadrature point (set-up
   and epilogue included), of K4 v1's innermost loop per sample and of K4
   v2's shared-memory point loop per point (patch 1 at K = 9, patch 4 at
   K = 11; the shared form, the per-pixel fallback being a function of its
   own) and of K12's (K = 9, rg = 2; v2: its 16-byte route's path through
   the shared form, ``shared_form_path``), of K5 v1's u-degree loop per lane
   and a-step (its Q = 16 and 32 instances) and of K5 v2's chunk loop per warp and chunk of N u-degrees
   (its instructions and HGMMA), with each one's MUFU.RSQ count, which give each
   kernel's issue bound at 132 SMs x 128 lanes x the card's maximum SM
   clock; then the
   card's ceilings (``roofline.measure_ceilings``: memory stream, float32
   FMA chains (8 independent a thread, and one, with the SM clock read while
   each runs), gather, ``expf``, ``rsqrtf``, L1 load and TF32 rates, the
   latter through ``wgmma`` (the bounds' rate) and ``mma.sync``), whose rates
   give every kernel's bound a second time beside the data sheet's
   (``bound_ms_measured``);
3. each kernel against its plain PyTorch version on the card, at the shapes
   the main path gives it: K1 (cosine mode sums) in each of its variants
   ("v1", "adaptive", "recur") on the coefficient field of a 77x300 crop and
   of the full 376x452 frame, from the init and the converged state, with
   its path counters (warps on the recur and on the exp body, modes
   evaluated) printed, and every warp of a converged state on the recur
   body; K2 (reduced edge gradients) on the full edge lattice, through its
   instance for K1 = 21 and, on the warm probe, its generic instance at 21
   and 13 and its instance for 25; float64
   within 1e-10 of each output's largest magnitude, float32 within 2e-4 of
   it plus 2e-5 relative (the plain K1 version is always the full sum: the
   cutoff and the recurrence differ from it at rounding level); K2 also at
   the |rho| clamp, where cancellation costs ~eps/(1-rho^2) in any
   precision: there each f32 version is held to the f64 golden (kernel error
   at most twice the plain version's); each kernel's device time, the median
   and minimum of 5 windows of 50 calls by CUDA events, each window queued
   behind a spin of the card so the host's pace is not timed (K1 "v1" and
   the default "recur", converged and from init; K2 and K3 also through the
   generic instance at the main rule), and the plain version's, beside the
   card's name, power limit and SM clock; each kernel's bound, the largest
   of its bytes at 3.35 TB/s (each input read once and each output written
   once), its float32 operations at 67 TFLOP/s (the fewest the function
   needs: for K2 and K3 the paired form) and, for K2 and K3, its square
   roots at 16 an SM a clock, from the work counts of
   ``gqmap_tpu_torch/kernels/roofline.py`` (``k1_work``, ``k2_work``,
   ``k3_work``), and the same at the measured ceilings;
4. one full 376x452 sweep from the same state three ways (kernels f32, plain
   f32, plain f64 = the golden), from the random init and from a converged-
   width state (sigma = 0.05): the kernel arm's error against the golden
   must be at most twice the plain f32 arm's; the same for the red-black
   order (``sweep_order="redblack"``: two half-steps, each kernel twice);
5. the slice: ``solve(GQMAPConfig.tpu_fast(its=900, eval_every=300), ...)``
   on the synthetic 376x452 pair (smoothed noise, I2 = I1 shifted one pixel
   right: u=1, v=0) with the launch counters of both kernels and of K8 and
   K9 (the sweep's update) reset just before it;
   the energy must stay finite, the AEPE at it=900 be at most half that at
   it=1, and each counter equal the sweep count; a second such solve must
   give the same AEPE trace, bit for bit. Then ms/sweep of 300-sweep
   segments from init and converged (the runner's route must be
   ``"graph"``), and the peak device memory;
6. K3 (tensor-rule edge sums) against its plain version on the full edge
   lattice through its instance for K=9, from the random init, a warm state
   (sigma drawn per site in [0.01, 3], |rho| <= 0.9) and the clamp state of
   phase 3, in float64 and float32 with the tolerances of phase 3, and at
   the clamp in float32 also against the f64 golden (ratio rule); on the
   warm probe also its generic instance at K=9 and K=5 and its instance for
   K=11; times as in phase 3;
6b. K4 (the bicubic node quadrature's raw sums) against its plain version,
   in both variants ("v1", and "v2", the default): at the main path's
   shapes: ``full_mixture``'s (3, 376, 452) sites at
   K = 9, ``super_entropy``'s (3, 94, 113) sites of 4x4 pixel blocks at
   K = 11, ``ctf_level``'s (1, 376, 452) at K = 11, and two ragged lattices
   (patch 1 and 4, a partial last block of threads), each from the init, the
   sigma = 0.05 state and the |rho| clamp; float64 within 1e-10 of each
   sum's largest magnitude, float32 against the f64 golden (ratio rule, the
   floor of phase 6); v2's share of CTAs with no window and of sites read
   through L1 (a site's box of the table over the budget) per probe, and its
   sums with every site sent through L1 (``window_bytes=0``) equal bit for
   bit; a shard's block (``origin``,
   ``local_image_shape``) equal to the whole lattice's sums there bit for
   bit and within 1e-10 of its plain version in float64; NaN means, sigmas
   and correlations at a few sites: NaN exactly there in both versions,
   every other site bit for bit the NaN-free call's; both variants' times
   back to back, converged and from init, the plain time, the bound (data
   sheet and measured ceilings, with the L1 tap term; the bound counts the
   function's work, in which a block's pixels share their weights and a
   (patch + 3)^2 tap window) and each variant's SASS issue bound at the
   three main shapes, and the time ``torch.take``'s measured gather rate
   would give v1's 16 taps a sample; at the converged probe v2 must take at
   most half of v1's time at ``super_entropy`` and no more than v1's at the
   two others;
6c. K5 (the Chebyshev series' node quadrature's raw sums) against its plain
   version, in both variants ("v1", and "v2", the default in float32, on the
   tensor cores; float64 runs "v1"), on the coefficient fields
   ``make_problem`` builds for the Stein
   Chebyshev paths: ``full_mixture(data_term="chebyshev", cheb_p=96,
   cheb_q=16)`` and ``tpu_fast(data_term="chebyshev")`` (64 x 16) on
   (3, 376, 452) sites at K = 9, ``super_entropy`` at 96 x 16 on the
   (3, 94, 113) lattice of 4x4 blocks at K = 11; from the init, the
   sigma = 0.05 state and the |rho| clamp: float64 within 1e-10 of each
   sum's largest magnitude, float32 against the f64 golden on the same
   field (ratio rule, the floor of phase 6); a shard's blocks (the (2, 2)
   mesh's at ``full_mixture``, one at odd offsets on the others) bit for bit
   the whole lattice's; NaN means, sigmas and correlations at a few sites:
   NaN exactly there in both versions, every other site bit for bit the
   NaN-free call's; two v2 launches bit for bit equal; each variant's time
   converged and from init, the plain version's, the plain version's
   ``torch.bmm`` calls alone (the contraction only, on its site-major blocks
   with a basis made beforehand), the bounds (``roofline.k5_work`` at the
   data sheet's and the measured rates: v2's with the contraction on the
   tensor cores, ``tensor_cores=True``, v1's on the FMA pipe), each
   variant's share of its bound and its SASS issue bound; the default
   variant must be the faster at ``full_mixture`` and ``tpu_fast``;
6d. K6 (the nearest lookup's node quadrature) and K7 (the Prewitt chain's)
   in both variants ("v1" reads the upsampled tables; "v2", the default,
   evaluates each cell from the padded fields by the tables' own phase
   stencil) against their plain versions at the main paths' shapes on 376x452:
   ``legacy_v2``'s windowed lookup (L = 1, K = 9, rg = 2, rfc = 6),
   ``blockmatch_v2``'s (K = 17), ``full_mixture(data_term="nearest")``'s
   (L = 3, K = 9; ``sweep_roofline``'s nearest mode) and ``legacy_v3``'s
   chain (K = 9, rfc = 4), each from the init, the sigma = 0.05 state and
   the |rho| clamp: float64 within 1e-10 of each sum's largest magnitude,
   float32 against the f64 golden (ratio rule), two float32 launches bit for
   bit, v2's sums v1's bit for bit on every probe in both types; a shard's
   blocks (the (2, 2) mesh's four and one at odd offsets) bit for bit the
   whole lattice's and, in float64, within 1e-10 of their plain version; NaN
   means, sigmas and correlations at a few sites: NaN where the plain
   version has NaN, within tolerance of it elsewhere, every other site bit
   for bit the NaN-free call's (both variants); on the sigma = 0.05 state,
   the init and a smooth field (every mean at the pair's shift, sigma =
   0.05), each variant's time in the same call, the plain version's, the
   distinct 32-byte table sectors the state's lookups touch, each variant's
   bound (``roofline.k6_work``/``k7_work`` at the data sheet's and the
   measured rates: v1's table bytes the sectors, v2's the padded fields and
   its stencil's operations), beside the time of one sector a lookup, the
   SASS issue bounds (v1: the point loop per point, every thread of the 32 x
   8 tiles; v2: a warp's round of 8 points of each of its 4 sites on the
   shared patch's path with its serial sums, every round) and ``torch.take``'s rate of
   random gathers over ``legacy_v2``'s table;
6e. K10 (the quadratic prior's node sums) and K11 (the truncated-quadratic
   tensor-rule edge sums), ``csrc/quad_gq.cu``, each variant (v2, the
   closed form and K11's classes; v1, the point loop) against their plain
   versions (``kernels/quad_gq``) at ``legacy_v1``'s K = 9 (quad_var 0.05;
   gama 1, dta 10) on (1, 376, 452) sites, at L = 20 (the plain versions 27
   points a step) and on a ragged (3, 61, 37) lattice, through the K = 9
   instance and the generic one (at K = 9 and 5), from the init, the sigma
   = 0.05 state and the |rho| clamp: float64 within 1e-10 of each sum's
   largest magnitude, float32 within 2e-4 of it plus 2e-5 relative, each
   with a floor of 1e-13 (float64) or 1e-5 (float32) of the largest |Ei| (a
   sum that is zero in exact arithmetic is rounding noise of that size),
   and at the clamp in float32 against the f64 golden (ratio rule); the
   cutoff, under a rule of unit weights (``quad_gq.unit_rule``): every element
   near it (neighbour means at +-dta within a few ulps, equal sigmas at both
   ends: K11 v2's per-lane form) and one element a warp near it, the rest
   well inside (the cooperative form), no sample on the other side of
   |d| = dta from the plain version's (each variant and instance, each v2
   form forced by ``quad_gq.COOP_LANES``, both types), v2's forms bit for bit each
   other, and at the true rule every site within the tolerance; NaN means,
   sigmas and correlations at a few sites: NaN exactly where the plain
   version has NaN and every other site bit for bit the NaN-free call's; a
   shard's blocks (the (2, 2) mesh's four and one at odd offsets) bit for
   bit the whole lattice's; each kernel's time in both variants (sigma
   0.05, the init and the clamp, the generic instance beside; K11 v2 also
   with each mixed form forced), K11 v2's class shares on each probe, the
   plain version's time, the bounds (``roofline.k10_work``, ``k11_work``
   with the probe's own classes, at the data sheet's and the measured
   rates), the share of each and the SASS issue bound (v1: the K = 9
   instance's whole function per point; v2: K10's function per site,
   K11's mixed forms per point);
6f. K12 (the windowed bicubic node term's raw sums, ``window_gq_kernel`` and
   ``window_gq_v2_kernel`` in ``csrc/node_gq.cu``) against its plain
   version (``kernels/window_gq``) in both variants on
   ``full_mixture(window_rg=2)``'s (3, 376, 452) and
   ``legacy_v2(data_term="bicubic")``'s (1, 376, 452) lattices at K = 9,
   rg = 2, from the init, the sigma = 0.05 state and the |rho| clamp:
   float64 (the runtime-K instance) within 1e-10 of each sum's largest
   magnitude, float32 (the K = 9 instance and the runtime-K one) against
   the f64 golden (ratio rule); v2's sums v1's bit for bit in float32 (and
   within 1e-10 of v1's runtime-rg instance in float64); every site through
   L1 (``window_bytes=0``) bit for bit the shared-window route, with the
   L1-route shares per probe; a shard's blocks (the (2, 2) mesh's four and
   one at odd offsets) bit for bit the whole lattice's and, in float64,
   within 1e-10 of their plain version; NaN means, sigmas and correlations
   at a few sites: NaN exactly there in both versions, every other site bit
   for bit the NaN-free call's; each instance's registers, local memory and
   resident CTAs an SM (``window_gq.occupancy``) beside ptxas's spills
   (every float32 v2 instance without local memory); the share of points
   whose window fails the border test (the per-tap fallback) at each probe;
   each variant's time (sigma 0.05 and the init, the runtime-K instance
   beside), the plain version's (2 calls after one), the bound
   (``roofline.k12_work`` at the data sheet's and the measured rates), the
   shares and the SASS issue bound (v1: the point loop of the shared-memory
   route; v2: its 16-byte route's shared-form path; every lane's rounds);
   each variant must be at least ``WINDOW_SPEEDUP`` times faster than the
   plain version on both lattices, the default no slower than the other;
7. one full 376x452 ``full_mixture`` sweep three ways (K4 and K3 f32, plain
   f32, plain f64 = the golden) from the init and the sigma = 0.05 states:
   the kernel arm's error against the golden at most twice the plain f32
   arm's;
8. the exact slice through the user entry point:
   ``solve(GQMAPConfig.full_mixture(quad_chunk=27, its=900, eval_every=300),
   ...)`` on the same pair with every launch counter reset just before it:
   finite energy, the AEPE at it=900 below that at it=1, K3's and K4's
   counters equal to the sweep count and K1's and K2's at 0; then ms/sweep
   of a 300-sweep segment and the split of one sweep into the node term (K4
   and its finalize; the plain version's time beside it), K3 and the rest,
   by CUDA events;
9. resume on the card: a 300-sweep solve that writes a checkpoint, resumed
   to 600 sweeps, ends in the state of an unbroken 600-sweep solve;
10. the kernels on the super lattice (``patch = 4``: 94x113 sites at
   376x452): K1 at A = 96 on ``tpu_fast_super``'s patch-summed coefficient
   field in each variant, from the init and the sigma = 0.05 state, with its
   path counters (every warp on the recur body at sigma = 0.05); K2 on its
   K1 = 25 instance and K3 on its K = 11 instance from an init, a warm and a
   clamp state; float64 and float32 with the tolerances and clamp rules of
   phases 3 and 6; each kernel's device time, plain time and bound there;
11. one full sweep of ``tpu_fast_super`` and of ``super_entropy`` three ways
   (as phase 4; the f64 golden of ``super_entropy`` takes its 121 node points
   in three steps), from the init and the sigma = 0.05 states;
12. 900-sweep ``tpu_fast_super`` and ``super_entropy`` solves through
   ``solve``, each with every launch counter set to 0 just before it: finite
   energy, the AEPE at it=900 below that at it=1, each path's kernels
   launched once a sweep (K4 and K3 on ``super_entropy``) and the others not
   at all, the peak device memory; a second ``tpu_fast_super`` solve
   identical bit for bit; then the split of one ``super_entropy`` sweep
   (node term through K4 with the plain version's time beside it, K3, rest)
   and ms/sweep of a 300-sweep ``tpu_fast_super`` segment;
13. a 300-sweep red-black ``tpu_fast`` solve whose K1 and K2 counters equal
   twice the sweeps, and ms/sweep of a 100-sweep red-black segment;
14. K3 on the legacy presets' L = 1 edge lattice (2, 2, 1, 376, 452) at K = 9
   (its instance, ``legacy_v2``/``legacy_v3``) and K = 17 (the generic
   instance, ``blockmatch_v2``), from an init, a warm and a clamp state, in
   float64 and float32 against the plain version and at the clamp in float32
   against the f64 golden (ratio rule), with its time, plain time and bound;
15. K1 on the window-meaned coefficient field of ``tpu_fast(window_rg=2)``
   against its plain version, from the init and the sigma = 0.05 state;
16. the legacy presets through the user entry points, each with every
   launch counter set to 0 just before it: 300-sweep ``legacy_v2``,
   ``legacy_v3`` and ``blockmatch_v2`` solves, K3 and K6 (K7 on
   ``legacy_v3``) launched once a sweep, each run three times, K6 and K7 in
   "v2", then "v1", then "v2" again (the same AEPE and energy traces bit for
   bit; each turn's wall), and
   ``tpu_fast(window_rg=2)``, K1 and K2 once a sweep; finite energy, the AEPE
   at it = 300 below that at it = 1; ``blockmatch_v2`` also from
   ``block_matching_init`` (which must find the pair's shift), whose AEPE
   rises as the reference's does (ROADMAP Queue 3, P4) but stays below the
   random init's run at it = 1 and at the end; ms a sweep of a 30-sweep
   segment from the final state of ``legacy_v3``, ``blockmatch_v2`` (from
   the block-matching init; both in turns, v2, v1, v2) and windowed
   ``tpu_fast``; then ``legacy_v1`` through
   ``make_problem(...)._replace(init_flow=...)`` and the segment runner (its
   quadratic prior is the block-matching flow; ``solve`` does not set it):
   K10 and K11 launched once a sweep (300 each) and K1-K7 not at all, the
   median interior mean within 0.15 of the prior's, the run's peak memory,
   and ms a sweep of 300-sweep graph segments converged and from init; on
   the run's final state K11 v2's class shares and K10's and K11's times in
   both variants, and a 30-sweep segment through K10/K11 v1 (the launches of
   v1's records); then
   300-sweep ``full_mixture(window_rg=2)`` and ``legacy_v2(data_term=
   "bicubic")`` solves: K12 and K3 once a sweep, every other kernel not at
   all, the AEPE falling, and the first's ms a sweep of a 30-sweep segment
   from its final state;
17. ``legacy_v2``'s ms a sweep (a 30-sweep segment from its solve's final
   state, in turns: v2, v1, v2), the node term's share of a sweep (K6 v2 and
   its finalize; through v1 and through the plain version beside it), K6
   alone in both variants (bit for bit the same sums) on the solve's final
   state and on the states of a legacy_v2 run from its init after 0, 10,
   30, 100 and 300 sweeps, each beside its bound (v1's from that state's
   table sectors), the
   seconds and memory to build its ``upsample_cubic`` table, and its solve's
   peak device memory;
18. one full-width ``legacy_v2(gradient_estimator="autodiff")`` sweep: a
   finite state and energy, K6 (the lookup's value) and K14 launched once
   each, its peak memory;
18b. the autodiff estimator's kernels at 376x452 (``kernels_autodiff``): K13
   (the bicubic node term's chain-rule sums, ``full_mixture``'s (3, 376,
   452) sites, K = 9), K14 (the tensor-rule Charbonnier edges' on its edge
   lattice) and K15 (the reduced Charbonnier edges' value and derivatives,
   K1 = 21) against their plain versions on the init, sigma = 0.05, the
   means on the flow range's integer bounds (queries on the frame's clamp)
   and the |rho| clamp, float64 within 1e-10 of each sum's largest magnitude
   (plus 1e-12), float32 by the ratio rule against the float64 golden, each
   in both variants, v2's sums v1's bit for bit on every probe (NaN and
   infinite inputs too; K15 also at K1 = 25 and 13 and through its generic
   instance), K13 v2's L1 route its shared route's bit for
   bit, with its L1-route shares; a shard's block bit for bit the whole
   lattice's (K13 at its pixel origin, K15 with its halo); NaN probes; each
   one's time (both variants in turns) beside its plain version's, its
   bound (``roofline.k13_work`` .. ``k15_work``) and its SASS issue bound;
18c. the three autodiff paths through ``make_segment_runner``
   (``autodiff_segments``: ``tpu_fast`` through K1 and K15, ``full_mixture``
   through K13 and K14, ``legacy_v2`` through K6 and K14): one sweep from the
   init and from sigma = 0.05 through the kernels no further from the
   float64 golden than twice the plain route (``node_kernel = edge_kernel =
   "torch"``); 30-sweep graph segments in turns, K13, K14 and K15 in v2,
   v1, v2 again, then the plain route: ms a sweep, the capturing call's
   peak memory, the kernels a replay launches (each path's once a sweep in
   either variant, none on the plain route);
18d. the configurations past a kernel's shape limit (``d7_phase``):
   ``tpu_fast(L=5)`` and ``tpu_fast_super(L=5)``, under the Stein and the
   autodiff estimators, one 376x452 sweep from the init and from sigma =
   0.05 through K1 in groups of components (3 + 2) three ways (kernels f32,
   plain f32, plain f64: the ratio rule), with K1's launches the groups'
   count a sweep; K1's time at L = 5 against L = 3; and
   ``full_mixture(K=65)`` on a crop, past K4's and K3's limits: one sweep
   on ``"auto"`` that launches neither and does not raise, and
   ``check_supported`` refusing ``"cuda"`` with the limit named;
18e. the autodiff estimator's windowed and super-lattice bicubic node terms'
   kernels (``kernels_chain_block``): K16 on ``full_mixture(window_rg=2)``'s
   (3, 376, 452) and ``legacy_v2(data_term="bicubic")``'s (1, 376, 452) sites
   (K = 9, rg = 2) and K13 at patch 4 on ``super_entropy``'s (3, 94, 113)
   (K = 11) against their plain versions on the init, sigma = 0.05, the
   |rho| clamp and the means on the flow range's integer bounds, float64
   within 1e-10, float32 by the ratio rule against the float64 golden; VV
   through L1 (its counts), the window as one copy and the runtime-K
   instance bit for bit the default route; a shard's block bit for bit; NaN
   probes; every instance free of local memory; each case's time beside its
   plain version's, its bound (``roofline.k16_work``, ``k13_work(patch=4)``)
   and its SASS issue bound;
18f. those three paths through ``make_segment_runner``
   (``chain_block_segments``): one sweep from the init and from sigma = 0.05
   three ways (kernels f32, plain route f32, plain f64) on the largest frame
   where the f64 golden fits; graph segments in turns: the kernels at
   376x452, the plain route (``node_kernel = edge_kernel = "torch"``) on the
   largest frame where it fits (printed, with the frames that ran out of
   memory), the kernels again; ms a sweep, capture peaks, K16 or K13 and K14
   once a replayed sweep, none on the plain route;
19. the command line (``gqmap_tpu_torch.cli.main.main``, in this process,
   every launch counter set to 0 before each call) on a synthetic dataset
   written under ``GQMAP_DATA``: two 376x452 sequences (smoothed noise,
   frame 2 warped by u = 1.5 + 1.5 cos(2 pi y / H), v = 0; GT in
   ``flow10.flo`` with five unknown pixels; the frames as
   ``preprocessed/<Name>.mat`` and, where ``imageio`` imports, as PNGs; the
   import test's result is printed): ``run --preprocessed --preset
   tpu_fast`` (600 sweeps: K1 and K2 once a sweep, K3 not at all, its best
   AEPE bit for bit a direct ``solve``'s and below the AEPE at it = 1),
   ``run --preprocessed`` (``full_mixture``, 300 sweeps: K3 and K4 once a
   sweep),
   ``run --devices 2`` in this one process (``RuntimeError`` naming the
   ``torch.distributed.run`` command), ``run --out`` (with
   ``imageio``: ``metrics.jsonl``, ``.npz``, a ``.flo`` equal to the MAP in
   f32 and one PNG a readout; without it: ``ImportError``);
20. the coarse-to-fine pyramid, ``solve_coarse_to_fine`` with
   ``ctf_level(its=300, eval_every=300)`` (scales 1/8 .. 1): K3 and K4
   launched once a sweep of every level, K1 and K2 not at all, every level's energy
   finite and rising over its solve; the final AEPE is printed beside the
   zero flow's, not checked against it: the reference's pyramid compounds
   each level's error and ends above it (ROADMAP Queue 3, P5); each level's
   and the whole's time, the peak memory, the finest level's ms a sweep (a 30-sweep
   segment) and its split into the node term (K4 and its finalize, the
   plain version beside it), K3 and the rest; with ``imageio`` also the
   ``ctf`` subcommand on the PNG frames;
21. ``sweep_lambdas`` over three values of lambda_s with ``tpu_fast(its=300)``
   (each best AEPE bit for bit a direct ``solve``'s) and the suite loop over
   both sequences; with ``imageio`` also the ``suite`` and ``sweep``
   subcommands against direct solves on the PNG frames;
22. ``structure_texture`` at 376x452 in float64 on the card within 1e-10 of
   its CPU result (of the image's range), with both times;
23. K3's K = 11 instance (``ctf_level``) on the L = 1 edge lattice at
   376x452 and at the pyramid's coarsest 47x57, from an init, a warm and a
   clamp state, float64 and float32 against the plain version and at the
   clamp in float32 against the f64 golden (ratio rule), with its time,
   plain time and bound;
24. the multi-device solve (``gqmap_tpu_torch.parallel``), in processes
   started together (this script with ``--rank``): 4 ranks on the one card
   over gloo (the backend rule: they share it) on a (2, 2) mesh of 188x226
   blocks, 1 rank over NCCL, and ``run --devices 2 --preprocessed`` under
   ``python -m torch.distributed.run`` with 2 ranks. The NCCL rank's sharded
   ``tpu_fast`` sweep equals ``make_sweep``'s bit for bit; on (2, 2) one
   ``tpu_fast`` and one ``full_mixture`` sweep in float64 (every field within
   1e-12 relative of this process's single-process sweep on the card) and
   float32 (error against the f64 golden at most twice the single-process
   f32 sweep's; the largest difference printed), one red-black ``tpu_fast``
   sweep in float32 (the same rule), K2 with its halo on each rank's padded
   block against its padded plain version in both types, each rank's launch
   counters (K1 = K2 = sweeps on ``tpu_fast``, twice on red-black, K3 = K4 =
   sweeps on ``full_mixture``, K5 = K3 = sweeps on the Chebyshev
   ``full_mixture``, 96 x 16, K7 = K3 = sweeps on ``legacy_v3``); the two
   ``full_mixture`` sweeps' and the ``legacy_v3`` sweep's state fields equal
   the single-process sweep's bit for bit in both types (K4, K5 or K7, and
   K3 on both sides); a 300-sweep ``solve(mesh=...)`` of
   ``tpu_fast`` (AEPE falls, the same result on every rank, final AEPE
   within 10% of phase 5's single-process solve at it = 300; its wall time,
   4 ranks time-sliced on one card, is printed and is no multi-GPU speed),
   and the command line's one JSON line, from rank 0. A failed rank fails
   the run;
25. the Chebyshev data term (``data_term="chebyshev"``, its node term
   through K5 where the JAX package runs an XLA scan): one 376x452 sweep
   three ways of ``full_mixture(quad_chunk=27, cheb_p=96, cheb_q=16)``
   through K5 and K3 and of ``tpu_fast(data_term="chebyshev")`` through K5
   and K2, from the init and the sigma = 0.05 states (the phase 4 rule;
   the plain arms plain on both terms), each kernel arm's launches, ms a
   sweep, node term (K5 and its plain version) and peak memory;
26. a ``full_mixture`` Chebyshev solve through ``solve`` (300 sweeps, a
   readout every 100; 100 and 50 where a sweep takes more than 0.1 s) with
   every launch counter set to 0 just before it: finite energy, the AEPE at
   the end below that at it = 1, K3 and K5 once a sweep, K1, K2 and K4 not
   at all; its peak memory;
27. the roofline harness at 376x452 on the measured ceilings:
   ``flagship_roofline`` (K1 alone in "v1" against its operation, exp and
   memory bounds; the ``tpu_fast`` sweep in a 300-sweep segment) and
   ``sweep_roofline`` over ``cosine``, ``chebyshev``, ``nearest`` and
   ``bicubic``; every bound below the time it bounds;
28. ``python -m gqmap_tpu_torch.cli.main bench`` in three processes, one
   after the other: one JSON line each with ``bench.py``'s keys, finite
   positive rates and the card's name and power limit; the three converged
   rates and their spread;
29. D4: ``run --devices 2`` under ``python -m torch.distributed.run`` with 2
   ranks on the card, 5 runs started together, every one exiting 0 with one
   JSON line (the command ends the process group it formed);
30. graph segments: the segment runner's graph route (one predicated sweep
   captured as a CUDA graph and replayed, ``(n, stop)`` read every ``POLL``
   sweeps) against its host loop (``_route="host"``) at 376x452 f32 on
   ``tpu_fast``, ``full_mixture``, red-black ``tpu_fast``,
   ``tpu_fast_super``, ``super_entropy``, ``ctf_level``, the Chebyshev
   ``full_mixture``, ``full_mixture(window_rg=2)`` and
   ``legacy_v2(data_term="bicubic")``: the route is
   ``"graph"``; from the init (300 sweeps)
   and the sigma = 0.05 state (300; 100 on the K4 and K5 paths) the final
   state, the sweep count, the three traces and the
   flag are the host loop's bit for bit, with the same launch counts and
   one read a window; each runner's ms a sweep by CUDA events, the capture's
   seconds and the capturing call's peak and reserved memory above what
   the script held; a ``tor`` that trips inside a poll window (from the host
   loop's |dmu| trace) gives the host loop's ``n``, flag, traces and state;
   the converged ``tpu_fast`` and ``tpu_fast_super`` segments' ms a sweep
   at each POLL of ``GRAPH_POLLS``; the two windowed bicubic paths converged
   in turns through K12 v2 (the default), v1 and v2 again (each variant's
   runner captured with it as ``window_gq._DEFAULT_VARIANT``; the three
   segments' states and traces bit for bit, the same launches), then around
   their plain sums (``WINDOW_PLAIN_SWEEPS`` sweeps, their capturing call's
   peak memory), K12 once a sweep and not at all around the plain sums;
   then 3 sweeps of every other
   single-process configuration (``legacy_v1``-``v3``, autodiff,
   ``blockmatch_v2``, windowed ``tpu_fast``, the Chebyshev ``tpu_fast``,
   ``tpu_fast`` in float64), graph against host loop bit for bit (K8's and
   K9's launches counted with the others').
   Every other segment and solve of the script (single process) runs the
   graph route too;
30b. the sweep's update, kernel K8 v2 (tiles staged by cp.async, each raw
   edge finalized once, one partial a tile; K9's tail in its last CTA;
   the device loop's carry) and v1 with K9 v1 beside it,
   ``csrc/sweep_update.cu``: PyTorch's reduction order of ``e.sum()``
   against ``sweep_update.card_sum`` for 1 to 64 values; on every path K8
   takes (``UPDATE_PATHS``: each preset, red-black, the legacy families,
   windowed ``tpu_fast``, both Chebyshev paths, ``full_mixture(window_rg=
   2)``) in float32 and float64 at
   the init, random-means and |rho|-clamp probes: from the same state and
   the same node and edge kernels' outputs, K8 v2's new state the plain
   glue's and K8 v1's bit for bit and the tail's energy, |dmu|, |dsigma|
   and dalpha within their summation order (float64 1e-12 of the terms'
   magnitudes, float32 by the ratio rule against the float64 golden); the
   carry (step, alpha, K1's phase stack, the neighbour stacks) after 3
   device-loop sweeps bit for bit its torch expressions, and unchanged
   under the stop flag; one sweep past ``alpha_start`` in both alpha modes
   through v2 and v1 (w within the sums' rule) and the carry after it;
   300-sweep ``tpu_fast`` and ``full_mixture`` solves (``tor = 0``)
   through K8 v2, v1 and the plain glue ending in the same state bit for
   bit; K8 v2's times (alone, with the tail, with the tail and the carry),
   v1's and K9 v1's (``tpu_fast``, ``full_mixture``, ``super_entropy``,
   ``legacy_v3``) beside the plain versions' and their bounds
   (``roofline.k8_work``, ``k9_work``, each variant's) at the data sheet's
   and the measured rates; each path's graph sweep in turns (v2, v1, the
   plain glue, v2 again) with the capturing call's peak memory, and on
   ``legacy_v1`` four turns more: K10 and K11 v1 then v2 again (the first
   turn's runner), K8 v2 around the plain versions of K10 and K11 (the sweep
   before them), and ``node_kernel = edge_kernel = "torch"`` (the plain sums
   and the plain glue), K10 and K11 once a sweep through the kernels (either
   variant) and not at all around the plain sums;
31. last, since the profiler's hooks may stay in the process: one
   ``tpu_fast``, ``full_mixture`` and Chebyshev ``full_mixture`` sweep from
   sigma = 0.05 under ``torch.profiler``, and a 20-sweep graph segment of
   the first two: wall and device time, the device's idle share, the
   kernel count and the top operators; one ``tpu_fast`` and one
   ``full_mixture`` graph replay and a 20-sweep segment through K8 v2,
   through K8 and K9 v1 and through the plain glue: at most 4 (``tpu_fast``)
   and 5 (``full_mixture``) kernels a sweep through v2, 20 through v1; one
   ``legacy_v1`` graph replay through K10, K11 and K8 v2 (at most 4 kernels:
   the raw lattice's copy beside them) and through K8 v2 around the plain
   sums; one ``full_mixture(window_rg=2)`` graph replay through K12, K3 and
   K8 v2 (at most 5 kernels, ``full_mixture``'s limit) and around its plain
   sums.

It prints the kernels' record as one JSON line before the last (``launches``
counts the main path's run: ``tpu_fast`` for K1, K2, K8 and K9 (K9 v2's tails,
each run by K8 v2's last CTA inside its launch; ``launches_of_its_own``, K9
v1's launches, is 0), ``full_mixture`` for
K3 and K4, the Chebyshev ``full_mixture`` solve for K5, the ``legacy_v2``
solve for K6, the ``legacy_v3`` solve for K7, the ``legacy_v1`` run for
K10 and K11, the ``full_mixture(window_rg=2)`` solve for K12, and phase
18c's 30-sweep segments of ``full_mixture`` (K13, K14) and ``tpu_fast``
(K15) under autodiff, each variant's first turn; ``launches_by_path``
every path's, the drivers', ``ctf``'s and the
sharded paths' (each rank's), the Chebyshev paths' and the roofline
phase's and the graph phase's included;
``super`` the checks, times and bounds on the super lattice, ``legacy``
K3's on the L = 1 lattice (K = 9, 17, and ``ctf_level``'s K = 11 at both
sizes) and ``windowed`` K1's on the window-meaned field), and last
``{"ok": true, "device": {...}}``. Any failed check exits non-zero without
that line; so does a machine without a CUDA card.
"""

import dataclasses
import functools
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from gqmap_tpu_torch.config import GQMAPConfig
from gqmap_tpu_torch.kernels import roofline
from gqmap_tpu_torch.kernels.roofline import TIMING, kernel_ms

H, W = 376, 452          # frame size of the synthetic pair (bench.py)
FR = (-10.0, 2.0, -2.0, 2.0)  # flow range: the constant GT gives a degenerate box
F64_TOL = 1e-10
F32_TOL = (2e-4, 2e-5)   # (of the output's largest magnitude, relative)
LANES_PER_CLOCK = 128  # H100 SXM: thread-instructions an SM issues a clock
# the rates of bound(), per second: "datasheet" (at the card's maximum SM
# clock) and "measured" (roofline.measure_ceilings), set in main()
RATES = {}
FAILURES = []
KERNELS = ("K1", "K2", "K3", "K4", "K5", "K6", "K7", "K10", "K11", "K12", "K13", "K14", "K15",
           "K16")


def launch_counts(**launches):
    """A launch count for every kernel: the ones given, 0 for the others."""
    return {k: launches.get(k, 0) for k in KERNELS}


def log(msg):
    print(msg, flush=True)


def require(ok, what):
    log(f"  [{'ok' if ok else 'FAIL'}] {what}")
    if not ok:
        FAILURES.append(what)


def smoothed_noise(r, H=H, W=W):
    """Uniform noise in [0, 255] under a 5x5 box filter."""
    img = r.uniform(0, 255, (H, W))
    k = np.ones(5) / 5
    img = np.apply_along_axis(lambda a: np.convolve(a, k, "same"), 0, img)
    return np.apply_along_axis(lambda a: np.convolve(a, k, "same"), 1, img)


def synthetic_pair():
    I1 = smoothed_noise(np.random.default_rng(0))
    I2 = np.roll(I1, 1, axis=1)
    gt = np.zeros((H, W, 2))
    gt[..., 0] = 1.0
    return I1, I2, gt


def smi(query):
    """One line of ``nvidia-smi --query-gpu=<query> --format=csv,noheader``."""
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60,
                          check=True).stdout.strip().splitlines()[0]


def sass_functions(text):
    """The instructions of every function in ``cuobjdump -sass`` output, as
    ``{name: [(address, instruction), ...]}``, and the address of each label."""
    funcs = {}
    for block in re.split(r"\n\s*Function : ", text)[1:]:
        name, body = block.split("\n", 1)
        label_addr, pending, instrs = {}, [], []
        for line in body.splitlines():
            m = re.match(r"\s*(\.L_x_\d+):", line)
            if m:
                pending.append(m.group(1))
                continue
            m = re.match(r"\s*/\*([0-9a-f]+)\*/\s+(.*?)\s*;", line)
            if m:
                addr = int(m.group(1), 16)
                label_addr.update((lab, addr) for lab in pending)
                pending = []
                instrs.append((addr, m.group(2)))
        funcs[name.strip()] = (instrs, label_addr)
    return funcs


def sass_loops(instrs, label_addr):
    """Every backward branch of one function: the instructions from its
    target label to the branch, and how many of them are
    MUFU.EX2, MUFU.RSQ, device-memory loads (LDG), shared-memory loads
    (LDS; LDS.128 also apart), float32 FMAs and multiplies (FFMA, FMUL), tensor-core products
    (HMMA: mma.sync; HGMMA: wgmma) and warp shuffles (SHFL)."""
    loops = []
    for addr, ins in instrs:
        m = re.search(r"\bBRA\S*\s+(?:`\()?(\.L_x_\d+|0x[0-9a-f]+)", ins)
        start = None if m is None else (int(m.group(1), 16) if m.group(1)[0] == "0"
                                        else label_addr.get(m.group(1)))
        if start is not None and start <= addr:
            body_ins = [i for a, i in instrs if start <= a <= addr]
            loops.append(dict(start=start, end=addr, instructions=len(body_ins),
                              ex2=sum("MUFU.EX2" in i for i in body_ins),
                              rsq=sum("MUFU.RSQ" in i for i in body_ins),
                              ldg=sum(bool(re.search(r"\bLDG\b", i)) for i in body_ins),
                              lds=sum(bool(re.search(r"\bLDS\b", i)) for i in body_ins),
                              lds128=sum("LDS.128" in i for i in body_ins),
                              fmul=sum(bool(re.search(r"\bF(FMA|MUL)\b", i)) for i in body_ins),
                              hmma=sum(i.startswith("HMMA") for i in body_ins),
                              hgmma=sum(i.startswith("HGMMA") for i in body_ins),
                              shfl=sum(bool(re.search(r"\bSHFL\b", i)) for i in body_ins)))
    return loops


def longest_block(instrs, label_addr):
    """The longest run of one function's instructions that no branch leaves
    and no branch enters (a basic block; K11 v2's per-lane form, fully
    unrolled with selects for the cutoff, is one), NOPs not counted."""
    starts = set(label_addr.values())
    for _, ins in instrs:
        m = re.search(r"\bBRA\S*\s+(?:!?U?P\w+,\s*)?(?:`\()?(0x[0-9a-f]+)", ins)
        if m:
            starts.add(int(m.group(1), 16))
    best, run = [], []
    for addr, ins in instrs:
        if addr in starts:
            best, run = max(best, run, key=len), []
        if not ins.startswith("NOP"):
            run.append(ins)
        if re.search(r"\b(BRA|EXIT|RET|CALL|BSSY|BSYNC|WARPSYNC|BREAK)\b", ins):
            best, run = max(best, run, key=len), []
    return max(best, run, key=len)


def shared_form_path(instrs, label_addr, loop, loops, calls=True):
    """The instructions one iteration of ``loop`` issues on the longest path
    through its basic blocks, from its first instruction to its back branch,
    that enters none of the loops nested in it (K12 v2: the shared form,
    where the inlined per-tap fallback holds the nested loop) and, with
    ``calls`` false, no call (the slow paths of sqrt and the division, K13
    v2's fallback); None where no path avoids them."""
    body = [(a, i) for a, i in instrs if loop["start"] <= a <= loop["end"]]
    nested = [(x["start"], x["end"]) for x in loops if x is not loop
              and loop["start"] <= x["start"] and x["end"] <= loop["end"]]
    index = {a: k for k, (a, _) in enumerate(body)}
    best = [None] * len(body)  # the longest path from instruction k, forward edges only
    for k in range(len(body) - 1, -1, -1):
        a, ins = body[k]
        if any(lo <= a <= hi for lo, hi in nested) or (not calls and "CALL" in ins):
            continue
        if a == loop["end"]:
            best[k] = [ins]
            continue
        # a branch's target (after a predicate operand, as in "@P0 BRA P1, 0x...")
        m = re.search(r"\bBRA\S*\s+(?:!?U?P\w+,\s*)?(?:`\()?(\.L_x_\d+|0x[0-9a-f]+)", ins)
        succ = []
        if m:
            t = int(m.group(1), 16) if m.group(1)[0] == "0" else label_addr.get(m.group(1))
            if t in index and t > a:
                succ.append(index[t])
        if (m is None and not ins.startswith("EXIT")) or ins.startswith("@"):
            succ.append(k + 1)
        paths = [best[j] for j in succ if j < len(body) and best[j] is not None]
        best[k] = [ins] + max(paths, key=len) if paths else None
    return best[0] if body else None


def sass_per_unit(cuobjdump, path, L=3, B=16, k1=21, K=9):
    """SASS instructions of each f32 kernel per unit of work. K1: its u-degree
    loop per mode (B x L modes an iteration; the recur loop has 3 L exp, the
    exp loop L + 2 (B - 1) L). K2, K3, K10 and K11: the whole function of the
    instance compiled for the main path's rule (K1 = k1, K = K; fully
    unrolled, so it has no loop) per quadrature point of the elements a
    thread computes (K2: both edges of a site; K3, K11: one element; K10: one
    site), so the figure includes the
    per-element set-up and epilogue; NOPs are not counted; beside it the
    function's MUFU.RSQ count. None where the function or loop is not found."""
    funcs = sass_functions(subprocess.run([cuobjdump, "-sass", path], capture_output=True,
                                          text=True, timeout=600, check=True).stdout)

    def find(key):
        return next((v for n, v in funcs.items() if key in n), ([], {}))

    per = {}
    lps = sass_loops(*find(f"cos_mode_sums_kernelIfLi{L}ELi{B}E"))
    for body, ex2 in (("recur", 3 * L), ("exp", L + 2 * (B - 1) * L)):
        lp = [x for x in lps if x["ex2"] == ex2]
        per[f"K1 {body} mode"] = lp[0]["instructions"] / (B * L) if lp else None
    for k, key, points in (("K2", f"edge_reduced_kernelIfLi{k1}EE", 2 * k1),
                           ("K3", f"edge_gq_kernelIfLi{K}EE", K * K),
                           ("K10", f"quad_node_kernelIfLi{K}EE", K * K),
                           ("K11", f"truncquad_edge_kernelIfLi{K}EE", K * K),
                           ("K10 v2", "quad_node_v2_kernelIfE", 1)):
        ins = [i for _, i in find(key)[0] if not i.startswith("NOP")]
        unit = "site" if k == "K10 v2" else "point"
        per[f"{k} {unit}"] = len(ins) / points if ins else None
        per[f"{k} rsq"] = sum("MUFU.RSQ" in i for i in ins) if ins else None
    # K11 v2 at K = 9, each mixed form per point of an element, in lane
    # instructions (a warp instruction is 32): the per-lane form, its longest
    # basic block (the unrolled 81 points, the rows' terms and the tree) per
    # point; the cooperative form, its pass loop (the loop with the element's
    # 6 shuffles and the xor tree's 24) a warp, 32 lanes, over the pass's two
    # elements' 2 K^2 points
    fn = find(f"truncquad_edge_v2_kernelIfLi{K}EE")
    block = longest_block(*fn) if fn[0] else []
    per["K11 v2 lane point"] = len(block) / (K * K) if block else None
    per["K11 v2 lane block"] = len(block) if block else None
    lp = [x for x in sass_loops(*fn) if x["shfl"] >= 30]
    lp = min(lp, key=lambda x: x["instructions"]) if lp else None
    per["K11 v2 pass"] = lp["instructions"] if lp else None
    per["K11 v2 coop point"] = 32 * lp["instructions"] / (2 * K * K) if lp else None
    # K4 v1: the innermost loop holding a sample's 16 table loads (LDG), per
    # sample (its LDG count / 16 samples an iteration); v2: the point loop of
    # the shared-memory route (the loop with the most LDS: the (P + 3)^2 taps
    # and the point's constants; the per-pixel fallback is a function of its
    # own) at patch 1 (K = 9) and 4 (K = 11), per point, the shared form
    lp = [x for x in sass_loops(*find("node_gq_kernelIfE")) if x["ldg"] >= 16]
    lp = min(lp, key=lambda x: x["instructions"]) if lp else None
    per["K4 v1 sample"] = lp["instructions"] * 16 / lp["ldg"] if lp else None
    per["K4 v1 rsq"] = lp["rsq"] * 16 / lp["ldg"] if lp else None
    for P, KK in ((1, K), (4, 11)):
        lp = [x for x in sass_loops(*find(f"node_gq_v2_kernelIfLi{P}ELi{KK}EE"))
              if x["lds"] >= (P + 3) ** 2]
        lp = max(lp, key=lambda x: x["lds"]) if lp else None
        per[f"K4 v2 point P={P}"] = lp["instructions"] if lp else None
        per[f"K4 v2 rsq P={P}"] = lp["rsq"] if lp else None
        per[f"K4 v2 lds P={P}"] = lp["lds"] if lp else None
    # K12: the point loop of the shared-memory route of the float K = 9, rg = 2
    # instance (the loop with the most LDS: the window's 64 taps and the
    # point's constants; the per-tap fallback is a function of its own), per
    # point, the shared form
    lp = [x for x in sass_loops(*find(f"window_gq_kernelIfLi{K}ELi2EE")) if x["lds"] >= 64]
    lp = max(lp, key=lambda x: x["lds"]) if lp else None
    per["K12 point"] = lp["instructions"] if lp else None
    per["K12 rsq"] = lp["rsq"] if lp else None
    per["K12 lds"] = lp["lds"] if lp else None
    # K12 v2: the point loop of the 16-byte route of the float K = 9, rg = 2
    # instance (the loop with the most LDS.128: the tap rows, frame 1's rows,
    # the point's constants), per point, on the shared form's path: less the
    # inlined per-tap fallback (shared_form_path)
    lps = sass_loops(*find(f"window_gq_v2_kernelIfLi{K}ELi2EE"))
    lp = max(lps, key=lambda x: x["lds128"]) if lps else None
    path = shared_form_path(*find(f"window_gq_v2_kernelIfLi{K}ELi2EE"), lp, lps) if lp else None
    per["K12 v2 point"] = len(path) if path else None
    per["K12 v2 rsq"] = sum("MUFU.RSQ" in i for i in path) if path else None
    per["K12 v2 lds"] = sum(bool(re.search(r"\bLDS\b", i)) for i in path) if path else None
    # K13, K14 and K15 (the autodiff estimator's), per point, and beside each
    # its MUFU a point (MUFU.RSQ of the roots, MUFU.RCP of the divisions), on
    # the hot path (shared_form_path with no call: sqrt's and the division's
    # slow paths, K13 v2's fallback, are calls). K13 v1: its point loop (the
    # loop with a point's 16 table loads, LDG, and its root); v2: the float
    # K = 9 instance's point loop of the shared-memory route (the loop with
    # the most LDS: the 16 taps and the point's constants). K14 v1 and K15
    # v1: the pair loop (the smallest loop with MUFU.RSQ, one a point) per
    # point; K14 v2 and K15 v2: the K = 9 (K1 = k1, 32-bit offsets) instance's
    # hot path through the whole function (its pairs unrolled, K15's two
    # edges interleaved; set-up and epilogue included) per point.
    def mufu(ins):
        return sum("MUFU" in i for i in ins)

    def hot(key, pick):
        fn = find(key)
        lps = sass_loops(*fn)
        lp = [x for x in lps if pick(x)]
        lp = lp[0] if lp else None
        return shared_form_path(*fn, lp, lps, calls=False) if lp else None

    for kern, key, pick in (
            ("K13 v1", "node_chain_kernelIfE", lambda x: x["ldg"] >= 16 and x["rsq"] >= 1),
            ("K13 v2", f"node_chain_v2_kernelIfLi{K}EE", lambda x: x["lds"] >= 16),
            ("K14 v1", "edge_chain_kernelIfE", lambda x: x["rsq"] >= 1),
            ("K15", "edge_diff_kernelIfE", lambda x: x["rsq"] >= 1)):
        path = hot(key, pick)
        points = 1 if kern.startswith("K13") else (
            sum("MUFU.RSQ" in i for i in path) if path else None)
        per[f"{kern} point"] = len(path) / points if path else None
        per[f"{kern} mufu"] = mufu(path) / points if path else None
    # K16 (the float K = 9, rg = 2 instance) and K13 at patch 4 (K = 11):
    # chain_block_kernel's point loop on its 16-byte route (the loop with the
    # most LDS.128: the tap rows, frame 1's rows, the point's constants), per
    # point, on the shared form's path (no call: the per-tap fallback and the
    # lane's exact sums are calls), with its MUFU
    for kern, key in (("K16", f"chain_block_kernelIfLi{K}ENS_10ChainBlockILi5ELb1E"),
                      ("K13 p4", "chain_block_kernelIfLi11ENS_10ChainBlockILi4ELb0E")):
        fn = find(key)
        lps = sass_loops(*fn)
        lp = max(lps, key=lambda x: x["lds128"]) if lps else None
        path = shared_form_path(*fn, lp, lps, calls=False) if lp else None
        per[f"{kern} point"] = len(path) if path else None
        per[f"{kern} mufu"] = mufu(path) if path else None
    for kern, key, points in (("K14 v2", f"edge_chain_v2_kernelIfLi{K}EE", K * K),
                              ("K15 v2", f"edge_diff_v2_kernelIfLi{k1}EjE", 2 * k1)):
        instrs, labels = find(key)
        exits = [a for a, i in instrs if "EXIT" in i]
        path = shared_form_path(instrs, labels, dict(start=instrs[0][0], end=max(exits)), [],
                                calls=False) if exits else None
        per[f"{kern} point"] = len(path) / points if path else None
        per[f"{kern} mufu"] = mufu(path) / points if path else None
    # K5: the u-degree loop of the instances for Q = 16 and 32 (the
    # innermost loop holding an a-step: the fewest instructions among those
    # with at least R (QB + 2) FFMA and FMUL, a row's QB - 1 products for each
    # of its R samples, the two outer sums and the recurrence), per lane and
    # a-step, and its 16-byte loads a step (QB / 4)
    for QB, R in ((16, 4), (32, 2)):
        lp = [x for x in sass_loops(*find(f"cheb_gq_kernelIfLi{QB}ELi{R}EE"))
              if x["fmul"] >= R * (QB + 2)]
        lp = min(lp, key=lambda x: x["instructions"]) if lp else None
        steps = lp["fmul"] / (R * (QB + 2)) if lp else None
        per[f"K5 a-step Q={QB}"] = lp["instructions"] / steps if lp else None
        per[f"K5 lds a-step Q={QB}"] = lp["lds"] / steps if lp else None
    # K5 v2: its product warps' chunk loop (the innermost loop holding
    # wgmmas, HGMMA, 3 QB / 8 a chunk of 32 u-degrees; its epilogue included),
    # per chunk and warp: its instructions and HGMMA (a unit's set-up and
    # tail, the helpers' work and the six sums are outside it)
    for QB, N in ((16, 96), (16, 64), (32, 96)):
        lp = [x for x in sass_loops(*find(f"cheb_gq_v2_kernelILi{QB}ELi{N}EE"))
              if x["hgmma"] >= 3 * QB // 8]
        lp = min(lp, key=lambda x: x["instructions"]) if lp else None
        chunks = lp["hgmma"] / (3 * QB // 8) if lp else None
        per[f"K5 v2 chunk Q={QB} N={N}"] = lp["instructions"] / chunks if lp else None
        per[f"K5 v2 hgmma chunk Q={QB} N={N}"] = lp["hgmma"] / chunks if lp else None
    # K6 and K7: the point loop (the innermost loop holding a point's table
    # loads, LDG: the (2 rg + 1)^2 taps of K6, K7's value and two fields) of
    # the float instances for rg = 2 and rg = 0 and of K7, per point
    for key, unit, ldg in (("nearest_gq_kernelIfLi2EE", "K6 point rg=2", 25),
                           ("nearest_gq_kernelIfLi0EE", "K6 point rg=0", 1),
                           ("nearest_chain_kernelIfE", "K7 point", 3)):
        lp = [x for x in sass_loops(*find(key)) if x["ldg"] >= ldg]
        lp = min(lp, key=lambda x: x["instructions"]) if lp else None
        per[unit] = lp["instructions"] if lp else None
        per[unit.replace("point", "rsq")] = lp["rsq"] if lp else None
    # K6 and K7 v2: a warp's round (8 points of each of its 4 sites; the
    # innermost loop holding the shared patch's loads, LDG: (2 rg + 4)^2 at
    # rg = 2 and 0, 3 x 16 for K7) as a warp runs it on the patch path, its
    # serial sums included: the loop's instructions less those of the loops
    # nested in it (a short last round's sums; at rg = 2 the window off the
    # patch, row by row; at rg = 0 and in K7 the cell off the patch is a call)
    for key, unit, ldg in (("nearest_gq_v2_kernelIfLi2EE", "K6 v2 round rg=2", 64),
                           ("nearest_gq_v2_kernelIfLi0EE", "K6 v2 round rg=0", 16),
                           ("nearest_chain_v2_kernelIfE", "K7 v2 round", 48)):
        lps = sass_loops(*find(key))
        rounds = [x for x in lps if x["ldg"] >= ldg]
        rnd = min(rounds, key=lambda x: x["instructions"]) if rounds else None
        per[unit] = per[unit.replace("round", "rsq")] = None
        if rnd is None:
            continue
        inner = [x for x in lps if rnd["start"] <= x["start"] and x["end"] <= rnd["end"]
                 and x is not rnd]
        top = [x for x in inner if not any(y is not x and y["start"] <= x["start"]
                                           and x["end"] <= y["end"] for y in inner)]
        per[unit] = rnd["instructions"] - sum(x["instructions"] for x in top)
        per[unit.replace("round", "rsq")] = rnd["rsq"] - sum(x["rsq"] for x in top)
    return per


def bound(work):
    """The least time of a call on the card for ``work`` (a
    ``roofline.k*_work`` count), the largest of: its bytes (each input read
    once, each output written once) at 3.35 TB/s, its float32 operations at
    67 TFLOP/s, and its square roots (a MUFU.RSQ each) at 16 an SM a clock;
    beside it the same at the measured ceilings (``bound_ms_measured``)."""
    rec = roofline.bound(work, RATES["datasheet"])
    measured = roofline.bound(work, RATES["measured"])
    return dict(rec, bound_ms_measured=measured["bound_ms"],
                bound_by_measured=measured["bound_by"])


def fmt_bound(rec):
    """A ``bound()`` record as text: the data sheet's bound, then the measured one."""
    return (f"bound {rec['bound_ms']:.4f} ms by {rec['bound_by']} (data sheet), "
            f"{rec['bound_ms_measured']:.4f} ms by {rec['bound_by_measured']} (measured "
            "ceilings)")


def time_ms(fn, n):
    """Mean time of ``fn`` over ``n`` calls after one warm-up, by CUDA events
    (the host's pace included where it is slower than the card)."""
    fn()
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(n):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / n


def profile_call(fn):
    """One call of ``fn`` under ``torch.profiler`` (after one unprofiled):
    its wall time to a synchronise, the summed device time of the kernels it
    launched, the device's idle share of the wall time (the profiler's own
    host cost included), the kernel count and the six aten operators with
    the most device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    device = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    ops = sorted((e for e in prof.key_averages() if e.key.startswith("aten::")),
                 key=lambda e: e.self_device_time_total, reverse=True)[:6]
    return dict(wall_ms=wall, device_ms=device, idle_share=1.0 - device / wall,
                kernels=len(kernels), top_ops_device_ms={e.key: e.self_device_time_total / 1e3
                                                         for e in ops})


def compare(got, want, dtype):
    """(max abs error, max error / largest |want|, within tolerance) over outputs."""
    abs_err, rel_err, ok = 0.0, 0.0, True
    for a, b in zip(got, want):
        err = (a - b).abs()
        scale = float(b.abs().max())
        abs_err = max(abs_err, float(err.max()))
        rel_err = max(rel_err, float(err.max()) / max(scale, 1e-300))
        if dtype == torch.float64:
            ok &= float(err.max()) <= F64_TOL * scale
        else:
            ok &= bool((err <= F32_TOL[0] * scale + F32_TOL[1] * b.abs()).all())
    return abs_err, rel_err, ok


def three_way_sweep(label, gold, plain32, kern32, probs, states, cast):
    """One sweep from each state through the f64 golden, the plain f32 and the
    kernel f32 arms: the kernel arm's error against the golden must be at most
    twice the plain arm's (mean |state - golden| of the worst field)."""
    fields = ("muu", "muv", "sigmau", "sigmav", "pn", "rou")
    for sname, st in states:
        g, gaux = gold(probs[torch.float64], st)
        errs = {}
        for arm, sw in (("plain f32", plain32), ("kernel f32", kern32)):
            o, aux = sw(probs[torch.float32], cast(st, torch.float32))
            errs[arm] = max(float((getattr(o, f).double() - getattr(g, f)).abs().mean())
                            for f in fields)
            e_rel = abs(float(aux.energy) - float(gaux.energy)) / abs(float(gaux.energy))
            log(f"  {label}{sname} {arm}: mean |state - golden| (worst field) "
                f"{errs[arm]:.3e}, energy rel err {e_rel:.3e}")
        require(errs["kernel f32"] <= 2.0 * errs["plain f32"],
                f"{label}sweep {sname}: kernel f32 error {errs['kernel f32']:.3e} <= 2 x plain "
                f"f32 error {errs['plain f32']:.3e}")


def l1_probes(st, gen):
    """An init state ``st`` (float64, L = 1) and two probes drawn from it
    with ``gen``: warm (|rho| <= 0.9, sigma per site in [0.01, 3]) and
    clamp (|rho| = 0.99999, the corr_tor corner, sigma as warm)."""

    def rand(lo, hi, like):
        return (lo + (hi - lo) * torch.rand(like.shape, generator=gen, dtype=torch.float64)
                ).to(like.device)

    return {
        "init": st,
        "warm": st._replace(rou=rand(-0.9, 0.9, st.rou), sigmau=rand(0.01, 3, st.sigmau),
                            sigmav=rand(0.01, 3, st.sigmav)),
        "clamp": st._replace(rou=0.99999 * torch.where(rand(0, 1, st.rou) < 0.5, -1.0, 1.0),
                             sigmau=rand(0.01, 3, st.sigmau), sigmav=rand(0.01, 3, st.sigmav)),
    }


def k3_on_l1(label, cfg, probes):
    """K3 through ``cfg``'s rule on the L = 1 edge lattice of each probe, in
    float64 and float32 against its plain version, and at the clamp in
    float32 against the f64 golden (ratio rule); returns the warm float32
    probe's record: error, device time, plain time and bound."""
    from gqmap_tpu_torch.kernels import edge_gq, edge_reduced_gq

    K = cfg.K
    rule = f"K={K} {'specialised' if K in edge_gq.SPECIALISED else 'generic'}"
    for dtype in (torch.float64, torch.float32):
        for sname, st in probes.items():
            mu = torch.stack([st.muu, st.muv]).to(dtype)
            sg = torch.stack([st.sigmau, st.sigmav]).to(dtype)
            rou = st.rou.to(dtype)
            args = (mu, sg, *edge_reduced_gq.neighbour_stacks(mu, sg), rou, K, cfg.lambdas,
                    cfg.epsn)
            got, want = edge_gq.edge_gq_cuda(*args), edge_gq.edge_gq_torch(*args)
            a, r, ok = compare(got, want, dtype)
            shape = tuple(rou.shape)
            require(ok, f"K3 {label} {shape} {rule} {str(dtype)[6:]} {sname}: max abs err "
                        f"{a:.3e}, rel {r:.3e}")
            if sname == "clamp" and dtype == torch.float32:
                gold = edge_gq.edge_gq_torch(*(x.double() if isinstance(x, torch.Tensor) else x
                                               for x in args))
                ek, ep = (max(float((x.double() - y).abs().max() / y.abs().max())
                              for x, y in zip(xs, gold)) for xs in (got, want))
                require(ek <= 2.0 * ep + 1e-6, f"K3 {label} {shape} {rule} float32 clamp: error "
                                               f"vs f64 golden kernel {ek:.3e} <= 2 x plain "
                                               f"{ep:.3e} + 1e-6")
            if sname != "warm" or dtype != torch.float32:
                continue
            ms = kernel_ms(lambda: edge_gq.edge_gq_cuda(*args))
            rec = dict(shape=list(shape), rule=rule, max_abs_err=a, ms=ms[0], ms_min=ms[1],
                       plain_ms=time_ms(lambda: edge_gq.edge_gq_torch(*args), 3),
                       library_ms=None, **bound(roofline.k3_work(shape, K)))
            log(f"  K3 {label} {shape} {rule} f32 on {smi('name,power.limit,clocks.sm')} "
                f"(median, min) {ms} ms; plain {rec['plain_ms']:.4f} ms; "
                f"{fmt_bound(rec)} ({rec['bound_terms_ms']})")
    return rec


def k4_probes(cfg, shape, dev):
    """States on ``cfg``'s lattice of the ``shape`` frame, float64: the init
    (``init_state``: wide sigma, zero correlation), sigma = 0.05 and the
    |rho| clamp (|pn| = 0.99999, sigma per site in [0.01, 3])."""
    from gqmap_tpu_torch import FlowRange
    from gqmap_tpu_torch.models import gqmap as pg

    c64 = dataclasses.replace(cfg, dtype="float64")
    st = pg.init_state(c64, FlowRange(*FR), shape, seed=0, device=dev)
    gen = torch.Generator().manual_seed(sum(shape) + cfg.K)

    def rand(lo, hi, like):
        return (lo + (hi - lo) * torch.rand(like.shape, generator=gen, dtype=torch.float64)
                ).to(dev)

    sign = torch.where(rand(0, 1, st.pn) < 0.5, -1.0, 1.0)
    return {"init": st,
            "converged": st._replace(sigmau=torch.full_like(st.sigmau, 0.05),
                                     sigmav=torch.full_like(st.sigmav, 0.05)),
            "clamp": st._replace(pn=0.99999 * sign, sigmau=rand(0.01, 3, st.sigmau),
                                 sigmav=rand(0.01, 3, st.sigmav))}


def kernels_k4(dev, record, I1, I2, gather_Mtaps_s, issue_ms):
    """Phase 6b: K4 against its plain version in both variants (see the
    module docstring); fills ``record["K4"]`` (v2, the default, at the
    ``full_mixture`` shape: error, times and bounds; v1's beside; the other
    shapes' under their names). ``issue_ms(unit, work)``: the SASS issue
    bound of ``work`` units."""
    from gqmap_tpu_torch import GQMAPConfig
    from gqmap_tpu_torch.kernels import node_gq
    from gqmap_tpu_torch.ops.interp import pad_cubic

    log("phase kernels K4")
    k4, plain = node_gq.node_gq_cuda, node_gq.node_gq_torch
    fm = GQMAPConfig.full_mixture()
    cases = {  # name: (configuration, frame crop)
        "full_mixture": (fm, (H, W)),
        "super_entropy": (GQMAPConfig.super_entropy(), (H, W)),
        "ctf_level": (GQMAPConfig.ctf_level(), (H, W)),
        "ragged patch 1": (dataclasses.replace(fm, L=2), (37, 53)),
        "ragged patch 4": (GQMAPConfig.super_entropy(L=2), (36, 52)),
    }

    def frames(shape, dtype):
        crop = (slice(0, shape[0]), slice(0, shape[1]))
        return (torch.as_tensor(I1[crop], dtype=dtype, device=dev),
                pad_cubic(torch.as_tensor(I2[crop], dtype=dtype, device=dev)))

    def sites(st, dtype):
        return [x.to(dtype).contiguous() for x in (st.muu, st.muv, st.sigmau, st.sigmav, st.pn)]

    def worst_rel(xs, gold):
        return max(float((x.double() - y).abs().max() / y.abs().max()) for x, y in zip(xs, gold))

    def issue(variant, site_shape, cfg):
        """The SASS issue bound of a launch: every lane of a site's group
        through every round (v1: its pixels a round, each point a sample;
        v2: its points, at the shared form's count)."""
        n_sites, P, K2 = math.prod(site_shape), cfg.patch, cfg.K ** 2
        if variant == "v1":
            G = node_gq.group_lanes(P)
            return issue_ms("K4 v1 sample", n_sites * G * -(-P * P // G) * K2)
        G = node_gq.v2_tile(P)[0]
        return issue_ms(f"K4 v2 point P={P}", n_sites * G * -(-K2 // G))

    rec = record["K4"] = dict(variant="v2", library_ms=None, library_reason=(
        "no single PyTorch call computes it: grid_sample's bicubic uses a = -0.75, not MATLAB's "
        "Keys a = -0.5, and has no quadrature"))
    for name, (cfg, shape) in cases.items():
        pkw = dict(patch=cfg.patch, quad_chunk=27)
        probes = k4_probes(cfg, shape, dev)
        site_shape = tuple(probes["init"].muu.shape)
        ctas = node_gq.v2_ctas(site_shape, cfg.patch)
        r4 = dict(shape=list(site_shape), K=cfg.K, patch=cfg.patch, l1_route_share={})
        for dtype in (torch.float64, torch.float32):
            I1d, VVd = frames(shape, dtype)
            for sname, st in probes.items():
                args = (I1d, VVd, *sites(st, dtype), cfg.K, cfg.lambdad, cfg.epsn)
                want = plain(*args, **pkw)
                gold = None if dtype == torch.float64 else plain(
                    *(x.double() if isinstance(x, torch.Tensor) else x for x in args), **pkw)
                for variant in node_gq.VARIANTS:
                    kw = dict(patch=cfg.patch, variant=variant)
                    cnt = torch.zeros(2, dtype=torch.int64, device=dev)
                    got = k4(*args, **kw, l1_counts=cnt if variant == "v2" else None)
                    a, r, ok = compare(got, want, dtype)
                    what = (f"K4 {variant} {name} {site_shape} K={cfg.K} patch={cfg.patch} "
                            f"{str(dtype)[6:]} {sname}")
                    if dtype == torch.float64:
                        require(ok, f"{what}: max abs err {a:.3e}, rel {r:.3e}")
                    else:
                        ek, ep = worst_rel(got, gold), worst_rel(want, gold)
                        require(ek <= 2.0 * ep + 1e-6,
                                f"{what}: error vs f64 golden kernel {ek:.3e} <= 2 x plain "
                                f"{ep:.3e} + 1e-6 (kernel vs plain max abs {a:.3e}, rel {r:.3e})")
                    if variant == "v2":
                        # the L1 route (a budget of 0): the same sums, bit for bit
                        every = torch.zeros(2, dtype=torch.int64, device=dev)
                        l1 = k4(*args, **kw, window_bytes=0, l1_counts=every)
                        n_ctas, n_sites = cnt.tolist()
                        share = dict(ctas=n_ctas / ctas, sites=n_sites / math.prod(site_shape))
                        r4["l1_route_share"][f"{sname} {str(dtype)[6:]}"] = share
                        require(every.tolist() == [ctas, math.prod(site_shape)]
                                and all(torch.equal(x, y) for x, y in zip(got, l1)),
                                f"{what}: {n_ctas} of {ctas} CTAs without a window, {n_sites} "
                                f"of {math.prod(site_shape)} sites through L1 ({share}); every "
                                f"site through L1 ({every.tolist()}) gives the same sums, bit "
                                "for bit")
                    if (dtype == torch.float64 or name.startswith("ragged")
                            or sname == "clamp"):
                        continue
                    ms = kernel_ms(lambda: k4(*args, **kw))
                    tag = "" if sname == "converged" else "init_"
                    r4[f"{variant}_{tag}ms"], r4[f"{variant}_{tag}ms_min"] = ms
                    if sname == "converged":
                        r4[f"{variant}_max_abs_err"] = a
                        r4[f"{variant}_sass_issue_ms"] = issue(variant, site_shape, cfg)
                if (dtype == torch.float32 and sname == "converged"
                        and not name.startswith("ragged")):
                    r4["plain_ms"] = time_ms(lambda: plain(*args, **pkw), 3)
        if name.startswith("ragged"):
            continue
        work = roofline.k4_work(site_shape, cfg.K, cfg.patch)
        taps = math.prod(site_shape) * cfg.K ** 2 * cfg.patch ** 2 * 16  # v1's
        r4.update(taps_v1=taps, take_ceiling_ms=taps / (gather_Mtaps_s * 1e6) * 1e3,
                  **bound(work))
        r4.update(ms=r4["v2_ms"], ms_min=r4["v2_ms_min"], max_abs_err=r4["v2_max_abs_err"],
                  sass_issue_ms=r4["v2_sass_issue_ms"])
        if name == "full_mixture":
            rec.update(r4)
        else:
            rec[name] = r4
        card = smi("name,power.limit,clocks.sm")
        for variant in node_gq.VARIANTS:
            log(f"  K4 {variant} {name} {site_shape} f32 on {card}: converged (median, min) "
                f"({r4[f'{variant}_ms']:.4f}, {r4[f'{variant}_ms_min']:.4f}) ms, init "
                f"({r4[f'{variant}_init_ms']:.4f}, {r4[f'{variant}_init_ms_min']:.4f}) ms; "
                f"SASS issue bound {r4[f'{variant}_sass_issue_ms']:.4f} ms")
        log(f"  K4 {name}: plain {r4['plain_ms']:.4f} ms; {fmt_bound(r4)} "
            f"({r4['bound_terms_ms']}); v2's L1-route shares {r4['l1_route_share']}; "
            f"v1's {taps:.3e} taps at torch.take's gather rate (not K4's bound) "
            f"{r4['take_ceiling_ms']:.4f} ms")
        if name in ("full_mixture", "super_entropy", "ctf_level"):
            half = name == "super_entropy"
            require(r4["v2_ms"] <= (0.5 if half else 1.0) * r4["v1_ms"],
                    f"K4 {name} converged: v2 {r4['v2_ms']:.4f} ms <= "
                    f"{'half of ' if half else ''}v1's {r4['v1_ms']:.4f} ms")

    # a shard's block: the whole lattice's sums there, bit for bit (the (2, 2)
    # mesh's four blocks; two blocks of the super lattice, one at odd offsets)
    hm, hn, sm, sn = H // 2, W // 2, H // 8, W // 8
    for name, blocks in (("full_mixture", [(r, c, hm, hn) for r in (0, hm) for c in (0, hn)]),
                         ("super_entropy", [(sm, sn, H // 4 - sm, W // 4 - sn), (0, 0, sm, sn)])):
        cfg, shape = cases[name]
        st = k4_probes(cfg, shape, dev)["converged"]
        for dtype, variant in ((d, v) for d in (torch.float64, torch.float32)
                               for v in node_gq.VARIANTS):
            I1d, VVd = frames(shape, dtype)
            s5 = sites(st, dtype)
            whole = k4(I1d, VVd, *s5, cfg.K, cfg.lambdad, cfg.epsn, patch=cfg.patch,
                       variant=variant)
            for r0, c0, m, n in blocks:
                blk = (slice(None), slice(r0, r0 + m), slice(c0, c0 + n))
                at = dict(patch=cfg.patch, origin=(r0 * cfg.patch, c0 * cfg.patch),
                          local_image_shape=(m * cfg.patch, n * cfg.patch))
                bs = [x[blk].contiguous() for x in s5]
                got = k4(I1d, VVd, *bs, cfg.K, cfg.lambdad, cfg.epsn, variant=variant, **at)
                same = all(torch.equal(g, w[blk]) for g, w in zip(got, whole))
                what = (f"K4 {variant} {name} {str(dtype)[6:]} block of ({m}, {n}) sites at "
                        f"lattice ({r0}, {c0})")
                if dtype == torch.float64:
                    a, r, ok = compare(got, plain(I1d, VVd, *bs, cfg.K, cfg.lambdad, cfg.epsn,
                                                  quad_chunk=27, **at), dtype)
                    require(ok, f"{what} against its plain version: max abs err {a:.3e}, "
                                f"rel {r:.3e}")
                require(same, f"{what}: the whole lattice's sums there, bit for bit")

    # NaN queries: NaN exactly at the sites with a NaN input, in both versions;
    # every other site as the NaN-free call gives it, bit for bit
    for name in ("full_mixture", "super_entropy"):
        cfg, shape = cases[name]
        st = k4_probes(cfg, shape, dev)["converged"]
        L, M, N = st.muu.shape
        at = [(0, M // 4, N // 5), (1, M // 2, N // 3), (2, M - 1, N - 1), (1, 0, N // 2)]
        mask = torch.zeros((L, M, N), dtype=torch.bool, device=dev)
        for site in at:
            mask[site] = True
        for dtype, variant in ((d, v) for d in (torch.float64, torch.float32)
                               for v in node_gq.VARIANTS):
            I1d, VVd = frames(shape, dtype)
            s5 = sites(st, dtype)
            clean = k4(I1d, VVd, *s5, cfg.K, cfg.lambdad, cfg.epsn, patch=cfg.patch,
                       variant=variant)
            for field, site in zip((0, 1, 3, 4), at):  # muu, muv, sigmav, pn
                s5[field][site] = float("nan")
            args = (I1d, VVd, *s5, cfg.K, cfg.lambdad, cfg.epsn)
            got = k4(*args, patch=cfg.patch, variant=variant)
            want = plain(*args, patch=cfg.patch, quad_chunk=27)
            torch.cuda.synchronize()
            ok = all(torch.equal(torch.isnan(g), mask) and torch.equal(torch.isnan(w), mask)
                     and torch.equal(g[~mask], c[~mask]) for g, w, c in zip(got, want, clean))
            require(ok, f"K4 {variant} {name} {str(dtype)[6:]} NaN probes at {at}: NaN exactly "
                        "there in the kernel and the plain version, every other site bit for "
                        "bit the NaN-free call's")


def kernels_k5(dev, record, issue_ms, sass):
    """Phase 6c: K5 (the Chebyshev series' node quadrature) against its
    plain version in both variants, "v1" and "v2" (the default in float32;
    float64 runs "v1"), see the module docstring; fills ``record["K5"]``
    (``full_mixture``'s 96 x 16 field: v2's error, times and bounds, v1's
    beside them; the other shapes under their names). ``issue_ms(unit,
    work)``: the SASS issue bound of ``work`` units; ``sass``: the SASS
    counts (:func:`sass_per_unit`)."""
    from gqmap_tpu_torch import FlowRange
    from gqmap_tpu_torch.kernels import cheb_gq
    from gqmap_tpu_torch.models import gqmap as pg
    from gqmap_tpu_torch.ops.chebyshev import _EVAL_CHUNK_ELEMS, _basis, site_major
    from gqmap_tpu_torch.ops.cosine import no_tf32

    log("phase kernels K5")
    k5, plain = cheb_gq.cheb_gq_cuda, cheb_gq.cheb_gq_torch
    I1, I2, _ = synthetic_pair()
    fr = FlowRange(*FR)
    cases = {  # the Stein paths' fields: (L, M, N) sites, P x Q degrees, K
        "full_mixture": GQMAPConfig.full_mixture(quad_chunk=27, **CHEB),
        "tpu_fast": GQMAPConfig.tpu_fast(data_term="chebyshev"),
        "super_entropy": GQMAPConfig.super_entropy(**CHEB),
    }
    runs = {torch.float64: ("v1",), torch.float32: cheb_gq.VARIANTS}

    def sites(st, dtype):
        return [x.to(dtype).contiguous() for x in (st.muu, st.muv, st.sigmau, st.sigmav, st.pn)]

    def worst_rel(xs, gold):
        return max(float((x.double() - y).abs().max() / y.abs().max()) for x, y in zip(xs, gold))

    def issue(variant, site_shape, K, P, Q):
        """The SASS issue bound of a launch: v1, every lane of every CTA
        through every a-step; v2, the product warps' chunk loop, every
        warpgroup (128 lanes) through every chunk of every unit."""
        L, M, N = site_shape
        QB = cheb_gq.q_width(Q)
        if variant == "v1":
            R, G, rounds = cheb_gq.lanes(L, K, Q, torch.float32)
            return issue_ms(f"K5 a-step Q={QB}", M * N * G * rounds * P)
        lay = cheb_gq.v2_layout(L, K, P, Q)
        return issue_ms(f"K5 v2 chunk Q={QB} N={lay['width']}",
                        128 * M * N * lay["units"] * lay["chunks"])

    def bmm_only(cheb, s5, K, quad_chunk):
        """The plain version's ``torch.bmm`` calls of one evaluation alone,
        on its site-major blocks with a basis made beforehand: the
        contraction of the series, not the function."""
        P, Q, M, N = cheb.coeffs.shape
        cs = cheb.coeffs.permute(2, 3, 0, 1).reshape(M * N, P, Q)
        chunk = quad_chunk if 0 < quad_chunk < K * K else K * K
        S = chunk * s5[0].shape[0]
        step = max(1, _EVAL_CHUNK_ELEMS // (S * P))
        up = 2 * torch.rand((S, min(step, M * N)), device=dev, dtype=cs.dtype) - 1
        Tu = _basis(up.T.contiguous(), P).permute(1, 2, 0)
        calls = [(j, min(step, M * N - j)) for _ in range(-(-K * K // chunk))
                 for j in range(0, M * N, step)]

        def run():
            with no_tf32():
                for j, n in calls:
                    torch.bmm(Tu[:n], cs[j:j + n])

        return kernel_ms(run, n=5)[0], len(calls)

    rec = record["K5"] = dict(variant=cheb_gq._DEFAULT_VARIANT, library_ms=None, library_reason=(
        "no single PyTorch call computes it: the plain version builds both bases, contracts them "
        "with each site's block by torch.bmm and sums the six quadrature sums; bmm_only_ms times "
        "its torch.bmm calls alone, the contraction only"))
    for name, cfg in cases.items():
        probs = {dt: pg.make_problem(dataclasses.replace(cfg, dtype=str(dt)[6:]), I1, I2, fr, dev)
                 for dt in (torch.float64, torch.float32)}
        probes = k4_probes(cfg, (H, W), dev)  # init, sigma = 0.05, the |rho| clamp
        L, M, N = site_shape = tuple(probes["init"].muu.shape)
        P, Q, K = cfg.cheb_p, cfg.cheb_q, cfg.K
        R, G, rounds = cheb_gq.lanes(L, K, Q, torch.float32)
        lay = cheb_gq.v2_layout(L, K, P, Q)
        unit = f"K5 v2 chunk Q={cheb_gq.q_width(Q)} N={lay['width']}"
        chunks = lay["units"] * lay["chunks"]  # a site's, each a warpgroup's
        r5 = dict(shape=list(site_shape), K=K, P=P, Q=Q, patch=cfg.patch,
                  v1_lanes=dict(lanes_a_site=G, samples_a_lane=R, rounds=rounds),
                  v2_layout=lay,
                  v2_sass_a_site=dict(
                      instructions=sass[unit] and 4 * sass[unit] * chunks,
                      hgmma=sass[unit.replace("chunk", "hgmma chunk")] and
                      sass[unit.replace("chunk", "hgmma chunk")] * chunks))
        for dtype in (torch.float64, torch.float32):
            cheb = probs[dtype].cheb
            for sname, st in probes.items():
                s5 = sites(st, dtype)
                want = plain(cheb, *s5, K, quad_chunk=27)
                gold = None if dtype == torch.float64 else plain(
                    cheb._replace(coeffs=cheb.coeffs.double()), *(x.double() for x in s5), K,
                    quad_chunk=27)
                for variant in runs[dtype]:
                    got = k5(cheb, *s5, K, variant=variant)
                    a, r, ok = compare(got, want, dtype)
                    what = (f"K5 {variant} {name} {site_shape} {P}x{Q} K={K} {str(dtype)[6:]} "
                            f"{sname}")
                    if dtype == torch.float64:
                        require(ok, f"{what}: max abs err {a:.3e}, rel {r:.3e}")
                        continue
                    ek, ep = worst_rel(got, gold), worst_rel(want, gold)
                    require(ek <= 2.0 * ep + 1e-6,
                            f"{what}: error vs f64 golden kernel {ek:.3e} <= 2 x plain {ep:.3e} "
                            f"+ 1e-6 (kernel vs plain max abs {a:.3e}, rel {r:.3e})")
                    if sname == "clamp":
                        continue
                    ms = kernel_ms(lambda: k5(cheb, *s5, K, variant=variant))
                    tag = "" if sname == "converged" else "init_"
                    r5[f"{variant}_{tag}ms"], r5[f"{variant}_{tag}ms_min"] = ms
                    if sname == "converged":
                        r5[f"{variant}_max_abs_err"] = a
                        r5[f"{variant}_sass_issue_ms"] = issue(variant, site_shape, K, P, Q)
                if dtype == torch.float32 and sname == "converged":
                    r5["plain_ms"] = time_ms(lambda: plain(cheb, *s5, K, quad_chunk=27), 3)
                    r5["bmm_only_ms"], r5["bmm_calls"] = bmm_only(cheb, s5, K, 27)
        # v2's bound counts the contraction on the tensor cores (3xTF32);
        # v1's, every operation on the FMA pipe
        v1b = bound(roofline.k5_work((M, N), K, P, Q, L))
        r5.update(**bound(roofline.k5_work((M, N), K, P, Q, L, tensor_cores=True)),
                  v1_bound_ms=v1b["bound_ms"], v1_bound_ms_measured=v1b["bound_ms_measured"],
                  v1_bound_terms_ms=v1b["bound_terms_ms"])
        default = cheb_gq._DEFAULT_VARIANT
        r5.update(ms=r5[f"{default}_ms"], ms_min=r5[f"{default}_ms_min"],
                  max_abs_err=r5[f"{default}_max_abs_err"],
                  sass_issue_ms=r5[f"{default}_sass_issue_ms"])
        prefix = {"v1": "v1_", "v2": ""}  # v2's bound is the record's own
        shares = {v: dict(sheet=r5[f"{prefix[v]}bound_ms"] / r5[f"{v}_ms"],
                          measured=r5[f"{prefix[v]}bound_ms_measured"] / r5[f"{v}_ms"],
                          issue=r5[f"{v}_sass_issue_ms"] / r5[f"{v}_ms"]
                          if r5[f"{v}_sass_issue_ms"] else None)
                  for v in cheb_gq.VARIANTS}
        r5["shares"] = shares
        if name == "full_mixture":
            rec.update(r5)
        else:
            rec[name] = r5
        card = smi("name,power.limit,clocks.sm")
        for v in cheb_gq.VARIANTS:
            log(f"  K5 {v} {name} {site_shape} {P}x{Q} K={K} f32 on {card}: converged (median, "
                f"min) ({r5[f'{v}_ms']:.4f}, {r5[f'{v}_ms_min']:.4f}) ms, init "
                f"({r5[f'{v}_init_ms']:.4f}, {r5[f'{v}_init_ms_min']:.4f}) ms; SASS issue bound "
                f"{r5[f'{v}_sass_issue_ms']} ms; share of its bound: data sheet "
                f"{shares[v]['sheet']:.1%}, measured {shares[v]['measured']:.1%}")
        log(f"  K5 {name}: plain {r5['plain_ms']:.4f} ms, its {r5['bmm_calls']} torch.bmm calls "
            f"alone {r5['bmm_only_ms']:.4f} ms; v2 (tensor cores) {fmt_bound(r5)} "
            f"({r5['bound_terms_ms']}); v1 (FMA pipe) bound {r5['v1_bound_ms']:.4f} ms (data "
            f"sheet), {r5['v1_bound_ms_measured']:.4f} ms (measured); v1 {G} lanes a site, {R} "
            f"samples a lane, {rounds} round(s); v2 {r5['v2_layout']}, its chunk loop's warp "
            f"instructions and warpgroup HGMMA a site {r5['v2_sass_a_site']}")
        if name in ("full_mixture", "tpu_fast"):
            other = "v1" if default == "v2" else "v2"
            require(r5[f"{default}_ms"] <= r5[f"{other}_ms"],
                    f"K5 {name} converged: the default {default} {r5[f'{default}_ms']:.4f} ms <= "
                    f"{other}'s {r5[f'{other}_ms']:.4f} ms")

        # a shard's blocks (the (2, 2) mesh's four; on the super lattice one at
        # odd offsets): the whole lattice's sums there, bit for bit
        st = probes["converged"]
        blocks = ([(r, c, M // 2, N // 2) for r in (0, M // 2) for c in (0, N // 2)]
                  if name == "full_mixture" else [(3, 5, M - 6, N - 7)])
        for dtype in (torch.float64, torch.float32):
            for variant in runs[dtype]:
                cheb, s5 = probs[dtype].cheb, sites(st, dtype)
                whole = k5(cheb, *s5, K, variant=variant)
                for r0, c0, m, n in blocks:
                    blk = (slice(None), slice(r0, r0 + m), slice(c0, c0 + n))
                    block = cheb._replace(
                        coeffs=site_major(cheb.coeffs[:, :, r0:r0 + m, c0:c0 + n]))
                    got = k5(block, *(x[blk].contiguous() for x in s5), K, variant=variant)
                    require(all(torch.equal(g, w[blk]) for g, w in zip(got, whole)),
                            f"K5 {variant} {name} {str(dtype)[6:]} block of ({m}, {n}) sites at "
                            f"lattice ({r0}, {c0}): the whole lattice's sums there, bit for bit")
                # NaN queries: NaN exactly at the sites with a NaN input, in both
                # versions; every other site as the NaN-free call gives it
                at = [(0, M // 4, N // 5), (1, M // 2, N // 3), (2, M - 1, N - 1),
                      (1, 0, N // 2)]
                mask = torch.zeros((L, M, N), dtype=torch.bool, device=dev)
                for site in at:
                    mask[site] = True
                for field, site in zip((0, 1, 3, 4), at):  # muu, muv, sigmav, pn
                    s5[field] = s5[field].clone()
                    s5[field][site] = float("nan")
                got = k5(cheb, *s5, K, variant=variant)
                want = plain(cheb, *s5, K, quad_chunk=27)
                torch.cuda.synchronize()
                require(all(torch.equal(torch.isnan(g), mask) and torch.equal(torch.isnan(w), mask)
                            and torch.equal(g[~mask], c[~mask])
                            for g, w, c in zip(got, want, whole)),
                        f"K5 {variant} {name} {str(dtype)[6:]} NaN probes at {at}: NaN exactly "
                        "there in the kernel and the plain version, every other site bit for bit "
                        "the NaN-free call's")
        if name == "full_mixture":
            # two v2 launches: one result, bit for bit
            s5 = sites(probes["init"], torch.float32)
            a, b = (k5(probs[torch.float32].cheb, *s5, K, variant="v2") for _ in range(2))
            require(all(torch.equal(x, y) for x, y in zip(a, b)),
                    f"K5 v2 {name}: two launches give the same sums, bit for bit")
        del probs
        torch.cuda.empty_cache()


def kernels_k6_k7(dev, record, I1, I2, issue_ms):
    """Phase 6d: K6 and K7 against their plain versions in both variants
    (see the module docstring); fills ``record["K6"]`` (``legacy_v2``'s
    windowed lookup: the default variant's error, times and bounds at the top
    level, each variant's under its name; the other shapes under theirs) and
    ``record["K7"]`` (``legacy_v3``'s chain). ``issue_ms(unit, work)``: the
    SASS issue bound of ``work`` units."""
    from gqmap_tpu_torch import GQMAPConfig
    from gqmap_tpu_torch.kernels import nearest_gq
    from gqmap_tpu_torch.ops.interp import pad_cubic, prewitt_gradients, upsample_cubic

    log("phase kernels K6/K7")
    t_phase = time.time()
    cases = {  # name: (kernel, configuration): the main paths of the two kernels
        "legacy_v2": ("K6", GQMAPConfig.legacy_v2()),
        "blockmatch_v2": ("K6", GQMAPConfig.blockmatch_v2()),
        "full_mixture nearest": ("K6", GQMAPConfig.full_mixture(data_term="nearest")),
        "legacy_v3": ("K7", GQMAPConfig.legacy_v3()),
    }
    f64, f32 = torch.float64, torch.float32
    variants = nearest_gq.VARIANTS
    tables = {}

    def tabs_for(cfg, chain, dtype):
        """frame 2's upsampled table and its pad (and the Prewitt fields'
        for K7), made once"""
        key = (cfg.rfc, chain, dtype)
        if key not in tables:
            I2d = torch.as_tensor(I2, dtype=dtype, device=dev)
            fields = (I2d, *prewitt_gradients(I2d)) if chain else (I2d,)
            tables[key] = ([upsample_cubic(x, cfg.rfc) for x in fields],
                           tuple(pad_cubic(x) for x in fields))
        return tables[key]

    def kernel_of(name):
        kern, cfg = cases[name]
        chain = kern == "K7"
        rest = (cfg.K, cfg.lambdad, cfg.epsn, cfg.rfc) + (() if chain else (cfg.window_rg,))
        fns = ((nearest_gq.nearest_chain_gq_cuda, nearest_gq.nearest_chain_gq_torch) if chain
               else (nearest_gq.nearest_gq_cuda, nearest_gq.nearest_gq_torch))
        return kern, cfg, chain, rest, fns

    def sites(st, dtype):
        return [x.to(dtype).contiguous() for x in (st.muu, st.muv, st.sigmau, st.sigmav, st.pn)]

    def worst_rel(xs, gold):
        return max(float((x.double() - y).abs().max() / y.abs().max()) for x, y in zip(xs, gold))

    def same(a, b):
        return all(torch.equal(x, y) for x, y in zip(a, b))

    before = {k: f.launches for k, f in (("K6", nearest_gq.nearest_gq_cuda),
                                          ("K7", nearest_gq.nearest_chain_gq_cuda))}
    for kern in ("K6", "K7"):
        record[kern] = dict(library_ms=None, library_reason=(
            "no single PyTorch call computes it: a gather (torch.take) and the Charbonnier "
            "quadrature sums are separate calls; the plain version is those calls"))
    bits = dict(calls=0, equal=0)  # v2 against v1 on every probe, both types
    for name in cases:
        kern, cfg, chain, rest, (fn, plain) = kernel_of(name)
        rg = 0 if chain else cfg.window_rg
        probes = k4_probes(cfg, (H, W), dev)
        # and a smooth field: every mean at the pair's shift, sigma = 0.05
        conv = probes["converged"]
        probes["smooth"] = conv._replace(muu=torch.ones_like(conv.muu),
                                         muv=torch.zeros_like(conv.muv))
        site_shape = tuple(probes["init"].muu.shape)
        L, M, N = site_shape
        lanes = L * -(-M // 8) * 8 * -(-N // 32) * 32  # v1's threads (32 x 8 CTAs)
        rounds = L * M * N * -(-cfg.K ** 2 // 8) * 8  # v2's warp rounds, in lanes
        unit = {"v1": "K7 point" if chain else f"K6 point rg={rg}",
                "v2": "K7 v2 round" if chain else f"K6 v2 round rg={rg}"}
        default = nearest_gq.resolve_variant(None, cfg.K, cfg.rfc)
        rec = dict(shape=list(site_shape), K=cfg.K, rg=rg, rfc=cfg.rfc, variant=default)
        gold = {}
        for dtype in (f64, f32):
            I1d = torch.as_tensor(I1, dtype=dtype, device=dev)
            tabs, pads = tabs_for(cfg, chain, dtype)
            for sname, st in probes.items():
                args = (I1d, *tabs, *sites(st, dtype))
                want = plain(*args, *rest, quad_chunk=27)
                if dtype == f64:
                    gold[sname] = want
                got = {}
                for variant in variants:
                    got[variant] = fn(*args, *rest, variant=variant, pads=pads)
                    a, r, ok = compare(got[variant], want, dtype)
                    what = (f"{kern} {variant} {name} {site_shape} K={cfg.K} rg={rg} "
                            f"{str(dtype)[6:]} {sname}")
                    if dtype == f64:
                        require(ok, f"{what}: max abs err {a:.3e}, rel {r:.3e}")
                        continue
                    ek, ep = worst_rel(got[variant], gold[sname]), worst_rel(want, gold[sname])
                    require(ek <= 2.0 * ep + 1e-6,
                            f"{what}: error vs f64 golden kernel {ek:.3e} <= 2 x plain {ep:.3e} "
                            f"+ 1e-6 (kernel vs plain max abs {a:.3e}, rel {r:.3e})")
                    require(same(got[variant], fn(*args, *rest, variant=variant, pads=pads)),
                            f"{what}: two launches give the same sums, bit for bit")
                    if sname == "converged":
                        rec[f"{variant}_max_abs_err"] = a
                bits["calls"] += 1
                bits["equal"] += same(got["v1"], got["v2"])
                require(same(got["v1"], got["v2"]),
                        f"{kern} {name} {str(dtype)[6:]} {sname}: v2's sums are v1's, bit for bit")
                if dtype == f64 or sname == "clamp":
                    continue
                tag = "" if sname == "converged" else f"{sname}_"
                for variant in variants:
                    ms = kernel_ms(lambda: fn(*args, *rest, variant=variant, pads=pads))
                    rec[f"{variant}_{tag}ms"], rec[f"{variant}_{tag}ms_min"] = ms
                rec[f"{tag}plain_ms"] = time_ms(lambda: plain(*args, *rest, quad_chunk=27), 3)
                lookups, sectors = nearest_gq.lookup_sectors(tabs[0], *args[-5:], cfg.K, cfg.rfc,
                                                             rg)
                rec[f"{tag}sectors"], rec["lookups"] = sectors, lookups
                for variant in variants:
                    work = (roofline.k7_work(site_shape, cfg.K, sectors, variant=variant)
                            if chain else roofline.k6_work(site_shape, cfg.K, rg, sectors,
                                                           variant=variant))
                    b = bound(work)
                    rec[f"{variant}_{tag}bound_ms"] = b["bound_ms"]
                    rec[f"{variant}_{tag}bound_ms_measured"] = b["bound_ms_measured"]
                    if sname == "converged":
                        rec[f"{variant}_bound"] = b
                        rec[f"{variant}_sass_issue_ms"] = issue_ms(
                            unit[variant], lanes * cfg.K ** 2 if variant == "v1" else rounds)
                        rec["lookup_sector_ms"] = (work["lookup_bytes"]
                                                   / RATES["datasheet"]["bytes"] * 1e3)
        # the default variant's numbers at the top level (the kernels line's)
        rec.update(rec[f"{default}_bound"], ms=rec[f"{default}_ms"],
                   ms_min=rec[f"{default}_ms_min"], max_abs_err=rec[f"{default}_max_abs_err"],
                   sass_issue_ms=rec[f"{default}_sass_issue_ms"])
        if name == "legacy_v2":
            # the card's rate of random 4-byte gathers over this table: torch.take
            # of uniform random indices, a tenth of the lookups K6 makes
            tab = tabs_for(cfg, chain, f32)[0][0]
            idx = torch.randint(0, tab.numel(), (rec["lookups"] // 10,), device=dev,
                                generator=torch.Generator(device=dev).manual_seed(0))
            ms = kernel_ms(lambda: torch.take(tab, idx), n=10)[0]
            rec["take_random_Glookups_s"] = idx.numel() / ms / 1e6
            del idx
        card = smi("name,power.limit,clocks.sm")
        log(f"  {kern} {name} {site_shape} K={cfg.K} rg={rg} rfc={cfg.rfc} f32 on {card}: "
            f"{rec['lookups']:.4e} lookups; one sector a lookup {rec['lookup_sector_ms']:.4f} "
            f"ms; default {default}")
        for variant in variants:
            b = rec[f"{variant}_bound"]
            log(f"    {variant}: SASS issue bound {rec[f'{variant}_sass_issue_ms']:.4f} ms; "
                f"converged {fmt_bound(b)} ({b['bound_terms_ms']})")
        for sname in ("converged", "init", "smooth"):
            tag = "" if sname == "converged" else f"{sname}_"
            log(f"    {sname}: (median, min) v1 ({rec['v1_' + tag + 'ms']:.4f}, "
                f"{rec['v1_' + tag + 'ms_min']:.4f}) ms, v2 ({rec['v2_' + tag + 'ms']:.4f}, "
                f"{rec['v2_' + tag + 'ms_min']:.4f}) ms, plain {rec[tag + 'plain_ms']:.4f} ms; "
                f"{rec[tag + 'sectors']} distinct sectors, v1 bound "
                f"{rec['v1_' + tag + 'bound_ms']:.4f} ms, v2 bound "
                f"{rec['v2_' + tag + 'bound_ms']:.4f} ms (data sheet); v1 "
                f"{rec['lookups'] / rec['v1_' + tag + 'ms'] / 1e6:.2f}, v2 "
                f"{rec['lookups'] / rec['v2_' + tag + 'ms'] / 1e6:.2f} G lookups/s")
        if "take_random_Glookups_s" in rec:
            log(f"    torch.take of uniform random indices over the table: "
                f"{rec['take_random_Glookups_s']:.2f} G lookups/s")
        if name in ("legacy_v2", "legacy_v3"):
            record[kern].update(rec)
        else:
            record[kern][name] = rec

    # a shard's block: the whole lattice's sums there, bit for bit (the (2, 2)
    # mesh's four blocks and one at odd offsets), and within 1e-10 of its
    # plain version in float64; NaN queries: NaN where the plain version has
    # NaN (a NaN cell reads the element the plain version reads), every other
    # site bit for bit the NaN-free call's; both variants
    hm, hn = H // 2, W // 2
    blocks = [(r, c, hm, hn) for r in (0, hm) for c in (0, hn)]
    blocks.append(((H // 10) | 1, (W // 9) | 1, H // 3, W // 2))  # at odd offsets
    for name, variant in ((n, v) for n in ("legacy_v2", "legacy_v3") for v in variants):
        kern, cfg, chain, rest, (fn, plain) = kernel_of(name)
        st = k4_probes(cfg, (H, W), dev)["converged"]
        for dtype in (f64, f32):
            I1d = torch.as_tensor(I1, dtype=dtype, device=dev)
            tabs, pads = tabs_for(cfg, chain, dtype)
            kw = dict(variant=variant, pads=pads)
            s5 = sites(st, dtype)
            whole = fn(I1d, *tabs, *s5, *rest, **kw)
            for r0, c0, m, n in blocks:
                blk = (slice(None), slice(r0, r0 + m), slice(c0, c0 + n))
                bs = [x[blk].contiguous() for x in s5]
                at = dict(origin=(r0, c0), local_image_shape=(m, n))
                got = fn(I1d, *tabs, *bs, *rest, **at, **kw)
                what = (f"{kern} {variant} {name} {str(dtype)[6:]} block of ({m}, {n}) sites at "
                        f"({r0}, {c0})")
                if dtype == f64:
                    a, r, ok = compare(got, plain(I1d, *tabs, *bs, *rest, quad_chunk=27, **at),
                                       dtype)
                    require(ok, f"{what} against its plain version: max abs err {a:.3e}, "
                                f"rel {r:.3e}")
                require(all(torch.equal(g, w[blk]) for g, w in zip(got, whole)),
                        f"{what}: the whole lattice's sums there, bit for bit")
            L, M, N = s5[0].shape
            at = [(0, M // 4, N // 5), (0, M // 2, N // 3), (0, M - 1, N - 1), (0, 0, N // 2)]
            mask = torch.zeros((L, M, N), dtype=torch.bool, device=dev)
            for site in at:
                mask[site] = True
            s5 = [x.clone() for x in s5]  # (a float64 field is the probe's own tensor)
            for field, site in zip((0, 1, 3, 4), at):  # muu, muv, sigmav, pn
                s5[field][site] = float("nan")
            got = fn(I1d, *tabs, *s5, *rest, **kw)
            want = plain(I1d, *tabs, *s5, *rest, quad_chunk=27)
            torch.cuda.synchronize()
            ok = True
            for g, w, c in zip(got, want, whole):
                ok &= torch.equal(torch.isnan(g), torch.isnan(w)) and torch.equal(g[~mask],
                                                                                   c[~mask])
                fine = ~torch.isnan(w)
                ok &= compare([g[fine]], [w[fine]], dtype)[2]
            require(ok, f"{kern} {variant} {name} {str(dtype)[6:]} NaN probes at {at}: NaN where "
                        "the plain version has NaN, within tolerance of it elsewhere, every "
                        "other site bit for bit the NaN-free call's")
    record["K6"]["v2_equals_v1_bit_for_bit"] = bits
    made = {k: f.launches - before[k] for k, f in (("K6", nearest_gq.nearest_gq_cuda),
                                                   ("K7", nearest_gq.nearest_chain_gq_cuda))}
    del tables
    torch.cuda.empty_cache()
    log(f"  phase kernels K6/K7 {time.time() - t_phase:.1f} s; v2's sums v1's bit for bit in "
        f"{bits['equal']} of {bits['calls']} probes; launches in this phase (checks and timing, "
        f"not a main path) {made}")


QUAD_SHAPES = {  # name: (L, M, N): legacy_v1's lattice, the update phase's L = 20, a ragged one
    "legacy_v1": (1, H, W),
    "L=20": (20, H, W),
    "ragged": (3, 61, 37),
}
QUAD_NODE = (9, 0.05)          # legacy_v1's K and the chip's quad_var (its prior dominant)
QUAD_EDGE = (9, 1.0, 10.0)     # legacy_v1's K, gama and dta
QUAD_RULES = ((9, False), (9, True), (5, True))  # (K, generic): K = 9's instance, the generic
QUAD_PLAIN_CHUNK = {"L=20": 27}  # the plain versions' points a step (their temporaries)
# the absolute floor of the K10/K11 checks, of the largest |Ei| (the size of
# the terms every sum adds): a sum that is zero in exact arithmetic (K10's Sxy
# at p = 0) is rounding noise of that size
QUAD_FLOOR = {torch.float64: 1e-13, torch.float32: 1e-5}


def compare_quad(got, want, dtype):
    """:func:`compare` with :data:`QUAD_FLOOR` beside each sum's tolerance
    (``want``'s first field is the value, ``Ei``)."""
    floor = QUAD_FLOOR[dtype] * float(want[0].abs().max())
    abs_err, rel_err, ok = 0.0, 0.0, True
    for a, b in zip(got, want):
        err = (a - b).abs()
        scale = float(b.abs().max())
        abs_err = max(abs_err, float(err.max()))
        rel_err = max(rel_err, float(err.max()) / max(scale, 1e-300))
        if dtype == torch.float64:
            ok &= float(err.max()) <= F64_TOL * scale + floor
        else:
            ok &= bool((err <= F32_TOL[0] * scale + F32_TOL[1] * b.abs() + floor).all())
    return abs_err, rel_err, ok


QUAD_VARIANTS = ("v2", "v1")  # K10 and K11: the default first
QUAD_V1_SWEEPS = 30  # legacy_v1's segment through K10/K11 v1 (the launches of v1's records)
QUAD_COOP = (0, 32)  # K11 v2's COOP_LANES that force each mixed form: per-lane, cooperative


def with_coop_lanes(lanes, fn):
    """``fn`` with ``quad_gq.COOP_LANES`` = ``lanes`` (None: as it is) while
    it runs: K11 v2's mixed form forced."""
    from gqmap_tpu_torch.kernels import quad_gq

    def run(*args, **kw):
        kept = quad_gq.COOP_LANES
        quad_gq.COOP_LANES = kept if lanes is None else lanes
        try:
            return fn(*args, **kw)
        finally:
            quad_gq.COOP_LANES = kept
    return run


def quad_classes(counts):
    """K11 v2's counters (``quad_gq.CLASS_COUNTS``) and their shares: of the
    elements (inside, outside, mixed), of the warps (with a mixed lane;
    cooperative, of those), of the mixed elements (cooperative)."""
    from gqmap_tpu_torch.kernels import quad_gq

    c = dict(zip(quad_gq.CLASS_COUNTS, (int(x) for x in counts)))
    n = c["inside"] + c["outside"] + c["mixed"]
    return dict(c, elements=n, share_inside=c["inside"] / n, share_outside=c["outside"] / n,
                share_mixed=c["mixed"] / n, share_mixed_warps=c["mixed warps"] / (-(-n // 32)),
                share_cooperative_warps=c["cooperative warps"] / max(c["mixed warps"], 1),
                share_cooperative_elements=c["cooperative elements"] / max(c["mixed"], 1))


def kernels_k10_k11(dev, record, issue_ms):
    """Phase 6e: K10 (the quadratic prior's node sums) and K11 (the
    truncated-quadratic tensor-rule edge sums), v2 and v1 in turn, against
    their plain versions on the card (see the module docstring); fills
    ``record["K10"]`` and ``record["K11"]``: a record a variant
    (``legacy_v1``'s lattice: error, times, bounds, SASS issue bound), K11
    v2's class shares on the probes (``classes``) and the cutoff's flips.
    ``issue_ms(unit, work)``: the SASS issue bound of ``work`` units."""
    from gqmap_tpu_torch import FlowRange, GQMAPConfig
    from gqmap_tpu_torch.kernels import quad_gq
    from gqmap_tpu_torch.models import gqmap as pg
    from gqmap_tpu_torch.ops.gq import gq_accumulate
    from gqmap_tpu_torch.ops.potentials import make_edge_pot_truncquad
    from gqmap_tpu_torch.ops.quadrature import build_table

    log("phase kernels K10/K11")
    t_phase = time.time()
    f64, f32 = torch.float64, torch.float32
    k10, k11 = quad_gq.quad_node_gq_cuda, quad_gq.truncquad_edge_gq_cuda
    cfg = GQMAPConfig.legacy_v1(quad_var=QUAD_NODE[1], dtype="float64")
    gen = torch.Generator().manual_seed(20)

    def rand(lo, hi, shape):
        return (lo + (hi - lo) * torch.rand(shape, generator=gen, dtype=f64)).to(dev)

    def probes(shape):
        """init (``init_state``: wide sigma, no correlation), sigma = 0.05
        (means over the flow range, |p| and |rho| up to 0.9) and the clamp
        (every correlation at +-0.99999, sigma in [0.01, 3]); the prior over
        the flow range"""
        L, M, N = shape
        st = pg.init_state(dataclasses.replace(cfg, L=L), FlowRange(*FR), (M, N), seed=L,
                           device=dev)
        sign = torch.where(rand(0, 1, (2, 2, L, M, N)) < 0.5, -1.0, 1.0)
        out = {"init": st,
               "sigma 0.05": st._replace(sigmau=torch.full_like(st.sigmau, 0.05),
                                         sigmav=torch.full_like(st.sigmav, 0.05),
                                         pn=rand(-0.9, 0.9, st.pn.shape),
                                         rou=rand(-0.9, 0.9, st.rou.shape)),
               "clamp": st._replace(pn=0.99999 * sign[0, 0], rou=0.99999 * sign,
                                    sigmau=rand(0.01, 3, st.sigmau.shape),
                                    sigmav=rand(0.01, 3, st.sigmav.shape))}
        return out, rand(FR[0], FR[1], (M, N, 2))

    def worst_rel(xs, gold):
        return max(float((x.double() - y).abs().max() / y.abs().max()) for x, y in zip(xs, gold))

    def classes_of(args, **kw):
        counts = torch.zeros(len(quad_gq.CLASS_COUNTS), dtype=torch.int64, device=dev)
        got = k11(*args, *QUAD_EDGE, counts=counts, **kw)
        return got, quad_classes(counts.tolist())

    kinds = {"K10": (k10, quad_gq.quad_node_gq_torch, QUAD_NODE),
             "K11": (k11, quad_gq.truncquad_edge_gq_torch, QUAD_EDGE)}
    reason = ("no PyTorch call computes the K^2-point raw sums (six Stein sums of a potential "
              "under the whitened tensor rule); the plain version is gq_accumulate's chain of "
              "elementwise calls and sums")
    recs = {k: dict(variant=quad_gq._DEFAULT_VARIANT, checks=0,
                    **{v: dict(library_ms=None, library_reason=reason) for v in QUAD_VARIANTS})
            for k in kinds}
    for name, shape in QUAD_SHAPES.items():
        sts, prior = probes(shape)
        chunk = QUAD_PLAIN_CHUNK.get(name, 0)
        for sname, st in sts.items():
            for dtype in (f64, f32):
                a10, a11 = quad_args(st, prior, dtype)
                for kern, args in (("K10", a10), ("K11", a11)):
                    fn, plain, rest = kinds[kern]
                    want = plain(*args, *rest, quad_chunk=chunk)
                    for K, generic in QUAD_RULES if name != "L=20" else QUAD_RULES[:1]:
                        if K == rest[0]:
                            w = want
                        else:
                            w = plain(*args, K, *rest[1:], quad_chunk=chunk)
                        g64 = None
                        for variant in QUAD_VARIANTS:
                            got = fn(*args, K, *rest[1:], generic=generic, variant=variant)
                            a, r, ok = compare_quad(got, w, dtype)
                            label = (f"{kern} {variant} {name} {tuple(args[1].shape)} K={K} "
                                     f"{'generic' if generic else 'specialised'} "
                                     f"{str(dtype)[6:]} {sname}")
                            recs[kern]["checks"] += 1
                            if dtype == f32 and sname == "clamp":
                                # each f32 version against the f64 golden on the same inputs
                                if g64 is None:
                                    g64 = plain(*(x.double() for x in args), K, *rest[1:],
                                                quad_chunk=chunk)
                                ek, ep = worst_rel(got, g64), worst_rel(w, g64)
                                require(ek <= 2.0 * ep + 1e-6,
                                        f"{label}: error vs f64 golden kernel {ek:.3e} <= 2 x "
                                        f"plain {ep:.3e} + 1e-6 (kernel vs plain {a:.3e})")
                            else:
                                require(ok, f"{label}: max abs err {a:.3e}, rel {r:.3e}")
                            if (name, sname, dtype, K, generic) == ("legacy_v1", "sigma 0.05",
                                                                    f32, 9, False):
                                recs[kern][variant]["max_abs_err"] = a
                            del got
                        del g64
                    del want
        del sts
        torch.cuda.empty_cache()

    # times at legacy_v1's lattice, v2 and v1 in turn: sigma 0.05, the init
    # and the clamp, the generic instance beside; K11 v2 with each mixed form
    # forced and its class shares; the plain version; the bounds (K11's from
    # the probe's own classes)
    sts, prior = probes(QUAD_SHAPES["legacy_v1"])
    tags = {"sigma 0.05": "", "init": "init_", "clamp": "clamp_"}
    classes = recs["K11"]["classes"] = {}
    for sname, tag in tags.items():
        a10, a11 = quad_args(sts[sname], prior, f32)
        classes[sname] = cl = classes_of(a11)[1]
        for kern, args in (("K10", a10), ("K11", a11)):
            fn, plain, rest = kinds[kern]
            for variant in QUAD_VARIANTS:
                rv = recs[kern][variant]
                rv[f"{tag}ms"], rv[f"{tag}ms_min"] = kernel_ms(
                    lambda: fn(*args, *rest, variant=variant))
            if kern == "K11":
                for c in QUAD_COOP:
                    recs[kern]["v2"][f"{tag}ms_coop_lanes_{c}"] = kernel_ms(
                        lambda: with_coop_lanes(c, fn)(*args, *rest))[0]
            if sname == "clamp":
                continue
            plain_ms = time_ms(lambda: plain(*args, *rest), 5)
            shape = tuple(args[1].shape) if kern == "K10" else tuple(args[4].shape)
            work = (roofline.k10_work(shape, rest[0]) if kern == "K10" else roofline.k11_work(
                shape, rest[0], classes=(cl["inside"], cl["outside"], cl["mixed"])))
            b = bound(work)
            n_el = math.prod(shape)
            for variant in QUAD_VARIANTS:
                rv = recs[kern][variant]
                rv[f"{tag}plain_ms"] = plain_ms
                rv[f"{tag}bound_ms"], rv[f"{tag}bound_by"] = b["bound_ms"], b["bound_by"]
                if sname != "sigma 0.05":
                    continue
                rv.update(b, shape=list(shape))
                rv["generic_ms"] = kernel_ms(
                    lambda: fn(*args, *rest, generic=True, variant=variant))[0]
                if variant == "v1":
                    rv["sass_issue_ms"] = issue_ms(f"{kern} point", n_el * rest[0] ** 2)
                elif kern == "K10":
                    rv["sass_issue_ms"] = issue_ms("K10 v2 site", n_el)
                else:  # the mixed forms' point loops alone
                    lane = issue_ms("K11 v2 lane point",
                                    (cl["mixed"] - cl["cooperative elements"]) * rest[0] ** 2)
                    coop = issue_ms("K11 v2 coop point",
                                    cl["cooperative elements"] * rest[0] ** 2)
                    rv["sass_issue_ms"] = None if lane is None or coop is None else lane + coop
                rv["share"] = dict(sheet=rv["bound_ms"] / rv["ms"],
                                   measured=rv["bound_ms_measured"] / rv["ms"],
                                   issue=(rv["sass_issue_ms"] / rv["ms"]
                                          if rv["sass_issue_ms"] else None))
    card = smi("name,power.limit,clocks.sm")
    for kern in kinds:
        for variant in QUAD_VARIANTS:
            rv = recs[kern][variant]
            log(f"  {kern} {variant} {tuple(rv['shape'])} K=9 f32 on {card} (median, min) of "
                f"{TIMING[0]} windows of {TIMING[1]} calls: sigma 0.05 ({rv['ms']:.4f}, "
                f"{rv['ms_min']:.4f}) ms, init ({rv['init_ms']:.4f}, {rv['init_ms_min']:.4f}) ms, "
                f"clamp {rv['clamp_ms']:.4f} ms, generic instance {rv['generic_ms']:.4f} ms; "
                f"plain {rv['plain_ms']:.4f} ms (init {rv['init_plain_ms']:.4f}); {fmt_bound(rv)} "
                f"({rv['bound_terms_ms']}; init {rv['init_bound_ms']:.4f} ms by "
                f"{rv['init_bound_by']}, share {rv['init_bound_ms'] / rv['init_ms']:.1%}); "
                f"SASS issue bound "
                f"{rv['sass_issue_ms']} ms; share of the bound: data sheet "
                f"{rv['share']['sheet']:.1%}, measured {rv['share']['measured']:.1%}")
    v2 = recs["K11"]["v2"]
    log("  K11 v2 with each mixed form forced (COOP_LANES 0: per-lane, 32: cooperative), ms: "
        + ", ".join(f"{s} {v2[t + 'ms_coop_lanes_0']:.4f} / {v2[t + 'ms_coop_lanes_32']:.4f}"
                    for s, t in tags.items())
        + f"; the default COOP_LANES {quad_gq.COOP_LANES}; classes: {json.dumps(classes)}")

    # the cutoff, under a rule of unit weights (quad_gq.unit_rule: Ei is the sum
    # of -d^2 / (2 gama) over the samples inside the cutoff), so a sample on
    # the other side of |d| = dta from the plain version's (|d| ~ dta there)
    # changes its element's Ei by about dta^2 / (2 gama). Two probes: "every
    # element" (neighbour means at +-dta from endpoint 1's within a few ulps,
    # equal sigmas at both ends: every element mixed, the per-lane form) and
    # "one in 32" (one element a warp so, the rest well inside with sigmas
    # ~1e-3: the cooperative form). Every variant, instance and form forced,
    # both types: no sample flipped; v2's forms bit for bit each other; at the
    # true rule every element within the tolerance. ``inside`` counts the
    # plain version's samples with |d| <= dta (its own d, the same unit rule)
    L, M, N = QUAD_SHAPES["legacy_v1"]
    K, gama, dta = QUAD_EDGE
    edge = (2, 2, L, M, N)
    mu = rand(-3, 3, (2, L, M, N))
    side = torch.where(rand(0, 1, edge) < 0.5, -1.0, 1.0)
    sg = rand(0.5, 3, (2, L, M, N))
    every = (mu, sg, mu[None] + side * dta * (1 + rand(-3e-7, 3e-7, edge)),
             sg[None].expand(edge).contiguous(), rand(-0.9, 0.9, edge))
    sg1 = rand(1e-3, 2e-3, (2, L, M, N))
    near = (torch.arange(M * N, device=dev) % 32 == 7).reshape(M, N)
    one = (mu, sg1, mu[None] + torch.where(near, side * dta * (1 + rand(-1e-7, 1e-7, edge)),
                                          rand(-1, 1, edge)),
           sg1[None].expand(edge).contiguous(), rand(-0.9, 0.9, edge))
    tab = torch.as_tensor(np.stack(build_table(K, 0, np.float64)))
    tab[2] = 1.0
    step = dta * dta / (2 * gama)
    flips = recs["K11"]["cutoff_flips"] = {}
    forms = (("v1", None, dict(variant="v1")), ("v1 generic", None, dict(variant="v1",
                                                                         generic=True)),
             ("v2", None, {}), ("v2 per-lane", QUAD_COOP[0], {}),
             ("v2 cooperative", QUAD_COOP[1], {}), ("v2 generic", None, dict(generic=True)))
    for pname, cut, form in (("every element", every, "per-lane"), ("one in 32", one,
                                                                    "cooperative")):
        for dtype in (f64, f32):
            args = [x.to(dtype) for x in cut]
            for variant in QUAD_VARIANTS:
                a, r, ok = compare_quad(k11(*args, *QUAD_EDGE, variant=variant),
                                        quad_gq.truncquad_edge_gq_torch(*args, *QUAD_EDGE), dtype)
                require(ok, f"K11 {variant} cutoff {pname} {str(dtype)[6:]} (legacy_v1's rule): "
                            f"max abs err {a:.3e}, rel {r:.3e}")
            want = gq_accumulate(make_edge_pot_truncquad(gama, dta), args[0][None], args[2],
                                 args[1][None], args[3], args[4], tab.to(dev, dtype))
            # the samples inside the cutoff of the elements near it
            at = torch.ones_like(near) if pname == "every element" else near
            inside = int(gq_accumulate(lambda x1, x2: ((x2 - x1).abs() <= dta).to(dtype),
                                       args[0][None], args[2], args[1][None], args[3], args[4],
                                       tab.to(dev, dtype)).Ei[..., at].sum())
            total = K * K * int(at.sum()) * want.Ei[..., 0, 0].numel()
            kept = {k: getattr(quad_gq, k) for k in ("rule_values", "closed_form_table",
                                                     "node_values")}
            for k, v in quad_gq.unit_rule(K).items():
                setattr(quad_gq, k, v)
            try:
                v2_sums = {}
                for fname, lanes, kw in forms:
                    counts = None
                    if fname.startswith("v2"):
                        got, counts = with_coop_lanes(lanes, classes_of)(args, **kw)
                        v2_sums[fname] = got
                    else:
                        got = k11(*args, *QUAD_EDGE, **kw)
                    n = int(((got.Ei - want.Ei).abs() / step).round().sum())
                    key = f"{pname}, {str(dtype)[6:]}, {fname}"
                    flips[key] = dict(flipped=n, classes=counts)
                    require(n == 0 and 0.1 < inside / total < 0.9,
                            f"K11 cutoff {key}: {n} samples on the other side of |d| = dta from "
                            f"the plain version's, of {K * K * want.Ei.numel()} ({inside} of the "
                            f"{total} near it inside)")
                    if fname == "v2":
                        cooperative = counts["cooperative warps"]
                        require(counts["mixed warps"] > 0 and cooperative == (
                            0 if form == "per-lane" else counts["mixed warps"]),
                                f"K11 cutoff {key}: the {form} form in every warp with a mixed "
                                f"lane ({counts})")
                require(all(torch.equal(x, y) for f in ("v2 per-lane", "v2 cooperative")
                            for x, y in zip(v2_sums[f], v2_sums["v2"])),
                        f"K11 cutoff {pname}, {str(dtype)[6:]}: v2's two mixed forms give the "
                        "same sums bit for bit")
            finally:
                for k, v in kept.items():
                    setattr(quad_gq, k, v)

    # NaN means, sigmas and correlations at a few sites: NaN exactly there
    # (as in the plain version), every other site bit for bit the NaN-free
    # call's; a shard's block (the (2, 2) mesh's four and one at odd offsets:
    # its sites and a view of the prior's block) bit for bit the whole
    # lattice's sums there; each variant
    sts, prior = probes((2, H, W))
    st = sts["sigma 0.05"]
    blocks = [(slice(r0, r0 + H // 2), slice(c0, c0 + W // 2)) for r0 in (0, H // 2)
              for c0 in (0, W // 2)] + [(slice(H // 10, H // 2 + 11), slice(11, W - W // 3))]
    for dtype in (f64, f32):
        a10, a11 = quad_args(st, prior, dtype)
        for kern, args in (("K10", a10), ("K11", a11)):
            fn, plain, rest = kinds[kern]
            for variant in QUAD_VARIANTS:
                base = fn(*args, *rest, variant=variant)
                lead = 1 if kern == "K10" else 3  # the fields' leading axes
                bad = ((0, 5, 7), (1, H // 2, 0), (1, H - 1, W - 1))
                nan_ok = True
                for i, at in enumerate(bad):
                    a2 = [x.clone() for x in args]
                    field = (1, 3, 5)[i] if kern == "K10" else (0, 1, 4)[i]
                    idx = at if a2[field].ndim == 3 else ((0,) * (a2[field].ndim - 3) + at)
                    a2[field][idx] = float("nan")
                    got, want = fn(*a2, *rest, variant=variant), plain(*a2, *rest)
                    for x, b, p in zip(got, base, want):
                        nan = torch.isnan(x)
                        nan_ok &= bool(torch.equal(nan, torch.isnan(p)) and nan.any()
                                       and torch.equal(x[~nan], b[~nan]))
                require(nan_ok, f"{kern} {variant} {str(dtype)[6:]} NaN sites: NaN exactly where "
                                "the plain version has NaN, every other site bit for bit the "
                                "NaN-free call's")
                blk_ok = True
                for rs, cs in blocks:
                    sl = (slice(None),) * lead + (rs, cs)
                    if kern == "K10":
                        bargs = [args[0][rs, cs]] + [x[:, rs, cs].contiguous() for x in args[1:]]
                    else:
                        bargs = ([x[:, :, rs, cs].contiguous() for x in args[:2]]
                                 + [x[:, :, :, rs, cs].contiguous() for x in args[2:]])
                    blk_ok &= all(torch.equal(x, b[sl]) for x, b in
                                  zip(fn(*bargs, *rest, variant=variant), base))
                require(blk_ok, f"{kern} {variant} {str(dtype)[6:]}: a shard's block (the (2, 2) "
                                "mesh's four, one at odd offsets) equals the whole lattice's sums "
                                "there, bit for bit")
    del sts, prior
    torch.cuda.empty_cache()
    record["K10"], record["K11"] = recs["K10"], recs["K11"]
    log(f"  phase kernels K10/K11: {recs['K10']['checks'] + recs['K11']['checks']} checks "
        f"against the plain versions (v2 and v1), cutoff flips {json.dumps(flips)}, "
        f"{time.time() - t_phase:.1f} s")


def quad_args(st, prior, dtype):
    """K10's (prior, five site fields) and K11's (mu, sg, u2e, o2e, rou) of a
    state and a prior, in ``dtype``."""
    from gqmap_tpu_torch.kernels import edge_reduced_gq

    site = [x.to(dtype).contiguous() for x in (st.muu, st.muv, st.sigmau, st.sigmav, st.pn)]
    mu, sg = torch.stack(site[:2]), torch.stack(site[2:4])
    return ((prior.to(dtype), *site),
            (mu, sg, *edge_reduced_gq.neighbour_stacks(mu, sg), st.rou.to(dtype)))


WINDOW_CASES = {  # name: the configuration whose (L, 376, 452) lattice K12 is probed on
    "full_mixture window_rg=2": GQMAPConfig.full_mixture(window_rg=2),
    "legacy_v2 bicubic": GQMAPConfig.legacy_v2(data_term="bicubic"),
}
WINDOW_PLAIN_CHUNK = 27  # the plain version's points a step (its (27, L, M, N) temporaries)
WINDOW_SPEEDUP = 10.0  # K12 at least this many times faster than its plain version


def border_fails(st, K, rg, frame):
    """The share of a state's (site, point) pairs whose window fails K12's
    border test (its first tap's query below 1 or its last tap's cell past
    the frame, or NaN: the kernel then samples each tap alone), and the share
    of warp rounds (a warp's 8 sites, each lane one point) with any such
    lane; in float64 from the state (the kernel tests in its own type)."""
    from gqmap_tpu_torch.kernels import node_gq, window_gq

    L, M, N = st.muu.shape
    Mo, No = frame
    P = 2 * rg + 1
    G, _, TC = window_gq.TILE
    dev = st.muu.device
    x = torch.as_tensor(node_gq.node_rule(K)[:K], device=dev)
    xi, xj = x.repeat(K), x.repeat_interleave(K)  # XJ outer, XI inner
    n = torch.arange(N, dtype=torch.float64, device=dev).reshape(N, 1)
    m = torch.arange(M, dtype=torch.float64, device=dev).reshape(M, 1, 1)
    rounds = -(-K * K // G)
    fails = rounds_with = 0
    for l in range(L):
        p = st.pn[l].double().unsqueeze(-1)
        sp, sm = torch.sqrt(1 + p), torch.sqrt(1 - p)
        s, t = (sp + sm) / 2, (sp - sm) / 2
        o1 = st.sigmau[l].double().unsqueeze(-1) * math.sqrt(2)
        o2 = st.sigmav[l].double().unsqueeze(-1) * math.sqrt(2)
        X0 = (n + 1 - rg) + (o1 * s * xi + o1 * t * xj + st.muu[l].double().unsqueeze(-1))
        Y0 = (m + 1 - rg) + (o2 * t * xi + o2 * s * xj + st.muv[l].double().unsqueeze(-1))
        fail = ~((X0 >= 1) & (torch.floor(X0) <= No - P) & (Y0 >= 1)
                 & (torch.floor(Y0) <= Mo - P))
        fails += int(fail.sum())
        lanes = torch.zeros((M, -(-N // TC) * TC, rounds * G), dtype=torch.bool, device=dev)
        lanes[:, :N, :K * K] = fail
        rounds_with += int(lanes.reshape(M, -1, TC, rounds, G).any(dim=4).any(dim=2).sum())
    return dict(points=fails / (L * M * N * K * K),
                warp_rounds=rounds_with / (L * M * -(-N // TC) * rounds))


def ptxas_entries(log_text):
    """``{entry function: dict(registers, stack, spill_stores, spill_loads)}``
    from a ``-Xptxas -v`` report."""
    out, name = {}, None
    lines = log_text.splitlines()
    for i, line in enumerate(lines):
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
            out[name] = {}
            continue
        m = re.search(r"Function properties for (\S+)", line)
        if m and m.group(1) == name and i + 1 < len(lines):
            nums = re.findall(r"(\d+) bytes", lines[i + 1])
            if len(nums) == 3:
                out[name].update(stack=int(nums[0]), spill_stores=int(nums[1]),
                                 spill_loads=int(nums[2]))
        m = re.search(r"Used (\d+) registers", line)
        if m and name is not None:
            out[name]["registers"] = int(m.group(1))
    return out


def k12_instances(dev):
    """K12's instances: for each (type, variant, K, rg, generic) a launch can
    select, its registers, local memory and resident CTAs an SM at the
    default window budget (``window_gq.occupancy``: the card's own report)
    beside ptxas's registers, stack and spills for that entry function."""
    from gqmap_tpu_torch.kernels import build, window_gq

    with open(build.library_path()[:-3] + ".log") as f:
        entries = ptxas_entries(f.read())
    out = {}
    for dtype in (torch.float32, torch.float64):
        t = "f" if dtype == torch.float32 else "d"
        for variant, rg, generic in ([("v1", 2, False), ("v1", 2, True)]
                                     + [("v2", rg, g) for rg in range(1, window_gq.MAX_RG + 1)
                                        for g in (False, True)]):
            if dtype == torch.float64 and generic:
                continue  # float64 has the runtime-K instances only
            kk = 9 if t == "f" and not generic and (variant == "v2" or rg == 2) else 0
            key = (f"window_gq_kernelI{t}Li{kk}ELi{2 if kk else 0}E" if variant == "v1"
                   else f"window_gq_v2_kernelI{t}Li{kk}ELi{rg}E")
            ptx = next((v for k, v in entries.items() if key in k), {})
            label = (f"{str(dtype)[6:]} {variant} " + ("K=9" if kk else "runtime K")
                     + (f" rg={rg}" if variant == "v2" or kk else " runtime rg"))
            out[label] = dict(window_gq.occupancy(9, rg, dtype, variant, generic=generic,
                                                  device=dev), ptxas=ptx)
    return out


def kernels_k12(dev, record, I1, I2, issue_ms):
    """Phase 6f: K12 (the windowed bicubic node term's raw sums) against its
    plain version in both variants (see the module docstring); fills
    ``record["K12"]``: under each variant ``full_mixture(window_rg=2)``'s
    lattice (error, times, bounds, shares, SASS issue bound), under
    ``legacy_v2 bicubic`` the same for its lattice, the border-fallback
    shares and the instance report. ``issue_ms(unit, work)``: the SASS issue
    bound of ``work`` units."""
    from gqmap_tpu_torch.kernels import window_gq
    from gqmap_tpu_torch.ops.interp import pad_cubic

    log("phase kernels K12")
    t_phase = time.time()
    k12, plain = window_gq.node_window_gq_cuda, window_gq.node_window_gq_torch
    G = window_gq.TILE[0]
    default = window_gq._DEFAULT_VARIANT
    variants = window_gq.VARIANTS
    units = {"v1": "K12 point", "v2": "K12 v2 point"}  # sass_per_unit's point loops

    def frames(dtype):
        return (torch.as_tensor(I1, dtype=dtype, device=dev),
                pad_cubic(torch.as_tensor(I2, dtype=dtype, device=dev)))

    def sites(st, dtype):
        return [x.to(dtype).contiguous() for x in (st.muu, st.muv, st.sigmau, st.sigmav, st.pn)]

    def worst_rel(xs, gold):
        return max(float((x.double() - y).abs().max() / y.abs().max()) for x, y in zip(xs, gold))

    def same(xs, ys):
        return all(torch.equal(x, y) for x, y in zip(xs, ys))

    rec = record["K12"] = dict(variant=default, checks=0, border_fallback_share={},
                               instances=k12_instances(dev))
    for label, inst in rec["instances"].items():
        log(f"  K12 instance {label}: {inst}")
        if label.startswith("float32 v2"):
            require(inst["local_bytes"] == 0 and inst["ptxas"].get("spill_stores") == 0,
                    f"K12 {label}: no local memory, no spill ({inst})")
    for name, cfg in WINDOW_CASES.items():
        K, rg = cfg.K, cfg.window_rg
        pkw = dict(quad_chunk=WINDOW_PLAIN_CHUNK)
        probes = k4_probes(cfg, (H, W), dev)
        site_shape = tuple(probes["init"].muu.shape)
        n_sites, ctas = math.prod(site_shape), window_gq.window_ctas(site_shape)
        rws = {v: dict(variant=v, shape=list(site_shape), K=K, rg=rg, l1_route_share={},
                       library_ms=None, library_reason=(
                           "no PyTorch call computes the windowed K^2-point sums; grid_sample's "
                           "bicubic uses a = -0.75, not MATLAB's Keys a = -0.5, and has no "
                           "quadrature or window")) for v in variants}
        border = rec["border_fallback_share"][name] = {
            sname: border_fails(st, K, rg, (H, W)) for sname, st in probes.items()}
        log(f"  K12 {name}: shares of points failing the border test (per-tap fallback) and of "
            f"warp rounds with such a point, by probe: {border}")
        for dtype in (torch.float64, torch.float32):
            I1d, VVd = frames(dtype)
            insts = ("specialised", "generic") if dtype == torch.float32 else ("generic",)
            for sname, st in probes.items():
                args = (I1d, VVd, *sites(st, dtype), K, cfg.lambdad, cfg.epsn, rg)
                want = plain(*args, **pkw)
                gold = None if dtype == torch.float64 else plain(
                    *(x.double() if isinstance(x, torch.Tensor) else x for x in args), **pkw)
                outs = {}
                for variant, inst in ((v, i) for v in variants for i in insts):
                    kw = dict(variant=variant, generic=inst == "generic")
                    cnt = torch.zeros(2, dtype=torch.int64, device=dev)
                    got = outs[variant, inst] = k12(*args, l1_counts=cnt, **kw)
                    a, r, ok = compare(got, want, dtype)
                    what = (f"K12 {variant} {name} {site_shape} K={K} rg={rg} {inst} "
                            f"{str(dtype)[6:]} {sname}")
                    rec["checks"] += 1
                    if dtype == torch.float64:
                        require(ok, f"{what}: max abs err {a:.3e}, rel {r:.3e}")
                    else:
                        ek, ep = worst_rel(got, gold), worst_rel(want, gold)
                        require(ek <= 2.0 * ep + 1e-6,
                                f"{what}: error vs f64 golden kernel {ek:.3e} <= 2 x plain "
                                f"{ep:.3e} + 1e-6 (kernel vs plain max abs {a:.3e}, rel {r:.3e})")
                    # the L1 route (a budget of 0): the same sums, bit for bit
                    every = torch.zeros(2, dtype=torch.int64, device=dev)
                    l1 = k12(*args, window_bytes=0, l1_counts=every, **kw)
                    n_ctas, n_l1 = cnt.tolist()
                    share = dict(ctas=n_ctas / ctas, sites=n_l1 / n_sites)
                    if inst == insts[0]:
                        rws[variant]["l1_route_share"][f"{sname} {str(dtype)[6:]}"] = share
                    require(every.tolist() == [ctas, n_sites] and same(got, l1),
                            f"{what}: {n_ctas} of {ctas} CTAs without a window, {n_l1} of "
                            f"{n_sites} sites through L1 ({share}); every site through L1 "
                            f"({every.tolist()}) gives the same sums, bit for bit")
                    if (dtype, inst, sname) == (torch.float32, "specialised", "converged"):
                        rws[variant]["max_abs_err"] = a
                    del l1
                # v2 is v1's arithmetic on v1's lanes: v1's compiled instance's sums
                # bit for bit, and its own runtime-K instance's; against v1's
                # runtime-rg instance (float64) within the tolerance
                v1, v2 = outs["v1", insts[0]], outs["v2", insts[0]]
                a, r, ok = compare(v2, v1, dtype)
                bits = same(v2, v1) and same(v2, outs["v2", "generic"])
                if dtype == torch.float32:
                    require(bits, f"K12 {name} float32 {sname}: v2's sums are v1's bit for bit "
                                  f"(both instances; max abs difference {a:.3e})")
                else:
                    require(ok, f"K12 {name} float64 {sname}: v2 against v1's runtime-rg "
                                f"instance max abs {a:.3e}, rel {r:.3e}; bit for bit: {bits}")
                del outs, want, gold

        # times (float32), each variant at sigma = 0.05 and from the init, its
        # runtime-K instance beside; the plain version (about half a second a
        # call: 2 after one)
        I1d, VVd = frames(torch.float32)
        for sname in ("converged", "init"):
            args = (I1d, VVd, *sites(probes[sname], torch.float32), K, cfg.lambdad, cfg.epsn, rg)
            tag = "" if sname == "converged" else "init_"
            for variant in variants:
                rw = rws[variant]
                rw[f"{tag}ms"], rw[f"{tag}ms_min"] = kernel_ms(lambda: k12(*args,
                                                                           variant=variant))
                rw[f"{tag}generic_ms"] = kernel_ms(lambda: k12(*args, variant=variant,
                                                               generic=True))[0]
            plain_ms = time_ms(lambda: plain(*args, **pkw), 2)
            for variant in variants:
                rws[variant][f"{tag}plain_ms"] = plain_ms
        work = bound(roofline.k12_work(site_shape, K, rg))
        card = smi("name,power.limit,clocks.sm")
        for variant in variants:
            rw = rws[variant]
            rw.update(work)
            rw["sass_issue_ms"] = issue_ms(units[variant], n_sites * G * -(-K * K // G))
            rw["share"] = dict(sheet=rw["bound_ms"] / rw["ms"],
                               measured=rw["bound_ms_measured"] / rw["ms"],
                               issue=(rw["sass_issue_ms"] / rw["ms"] if rw["sass_issue_ms"]
                                      else None))
            rw["speedup"] = rw["plain_ms"] / rw["ms"]
            log(f"  K12 {variant} {name} {site_shape} K={K} rg={rg} f32 on {card} (median, min) "
                f"of {TIMING[0]} windows of {TIMING[1]} calls: sigma 0.05 ({rw['ms']:.4f}, "
                f"{rw['ms_min']:.4f}) ms, init ({rw['init_ms']:.4f}, {rw['init_ms_min']:.4f}) ms; "
                f"runtime-K instance {rw['generic_ms']:.4f} / {rw['init_generic_ms']:.4f} ms; "
                f"plain {rw['plain_ms']:.4f} / {rw['init_plain_ms']:.4f} ms "
                f"({rw['speedup']:.0f}x); {fmt_bound(rw)} ({rw['bound_terms_ms']}); SASS issue "
                f"bound {rw['sass_issue_ms']} ms; share of the bound: data sheet "
                f"{rw['share']['sheet']:.1%}, measured {rw['share']['measured']:.1%}, issue "
                f"{rw['share']['issue']}; L1-route shares {rw['l1_route_share']}")
            require(rw["speedup"] >= WINDOW_SPEEDUP and rw["init_plain_ms"] >= WINDOW_SPEEDUP
                    * rw["init_ms"], f"K12 {variant} {name}: at least {WINDOW_SPEEDUP:g}x faster "
                                     f"than its plain version ({rw['speedup']:.1f}x at sigma "
                                     f"0.05, {rw['init_plain_ms'] / rw['init_ms']:.1f}x from "
                                     "init)")
        other = next(v for v in variants if v != default)
        require(rws[default]["ms"] <= rws[other]["ms"],
                f"K12 {name}: the default variant {default} ({rws[default]['ms']:.4f} ms) no "
                f"slower than {other} ({rws[other]['ms']:.4f} ms) at sigma 0.05")
        if name == "full_mixture window_rg=2":
            rec.update(rws)
        else:
            rec[name] = rws
        del probes
        torch.cuda.empty_cache()

    # a shard's block (frame 1 and VV whole, addressed at its pixel origin;
    # windows across the cut): the (2, 2) mesh's four blocks and one at odd
    # offsets, the whole lattice's sums there bit for bit, and in float64
    # within 1e-10 of its plain version
    cfg = WINDOW_CASES["full_mixture window_rg=2"]
    K, rg = cfg.K, cfg.window_rg
    st = k4_probes(cfg, (H, W), dev)["converged"]
    hm, hn = H // 2, W // 2
    blocks = [(r0, c0, hm, hn) for r0 in (0, hm) for c0 in (0, hn)] + [(37, 51, 101, 203)]
    for dtype, variant in ((d, v) for d in (torch.float64, torch.float32) for v in variants):
        I1d, VVd = frames(dtype)
        s5 = sites(st, dtype)
        whole = k12(I1d, VVd, *s5, K, cfg.lambdad, cfg.epsn, rg, variant=variant)
        for r0, c0, m, n in blocks:
            blk = (slice(None), slice(r0, r0 + m), slice(c0, c0 + n))
            at = dict(origin=(r0, c0), local_image_shape=(m, n))
            bs = [x[blk].contiguous() for x in s5]
            got = k12(I1d, VVd, *bs, K, cfg.lambdad, cfg.epsn, rg, variant=variant, **at)
            what = f"K12 {variant} {str(dtype)[6:]} block of ({m}, {n}) sites at ({r0}, {c0})"
            if dtype == torch.float64:
                a, r, ok = compare(got, plain(I1d, VVd, *bs, K, cfg.lambdad, cfg.epsn, rg,
                                              quad_chunk=WINDOW_PLAIN_CHUNK, **at), dtype)
                require(ok, f"{what} against its plain version: max abs err {a:.3e}, rel {r:.3e}")
            require(all(torch.equal(g, w[blk]) for g, w in zip(got, whole)),
                    f"{what}: the whole lattice's sums there, bit for bit")

    # NaN means, sigmas and correlations at a few sites: NaN exactly there in
    # the kernel and the plain version, every other site bit for bit the
    # NaN-free call's
    L, M, N = st.muu.shape
    at = [(0, M // 4, N // 5), (1, M // 2, N // 3), (2, M - 1, N - 1), (1, 0, N // 2)]
    mask = torch.zeros((L, M, N), dtype=torch.bool, device=dev)
    for site in at:
        mask[site] = True
    for dtype, variant in ((d, v) for d in (torch.float64, torch.float32) for v in variants):
        I1d, VVd = frames(dtype)
        s5 = [x.clone() for x in sites(st, dtype)]
        clean = k12(I1d, VVd, *s5, K, cfg.lambdad, cfg.epsn, rg, variant=variant)
        for field, site in zip((0, 1, 3, 4), at):  # muu, muv, sigmav, pn
            s5[field][site] = float("nan")
        args = (I1d, VVd, *s5, K, cfg.lambdad, cfg.epsn, rg)
        got, want = k12(*args, variant=variant), plain(*args, quad_chunk=WINDOW_PLAIN_CHUNK)
        torch.cuda.synchronize()
        ok = all(torch.equal(torch.isnan(g), mask) and torch.equal(torch.isnan(w), mask)
                 and torch.equal(g[~mask], c[~mask]) for g, w, c in zip(got, want, clean))
        require(ok, f"K12 {variant} {str(dtype)[6:]} NaN probes at {at}: NaN exactly there in "
                    "the kernel and the plain version, every other site bit for bit the "
                    "NaN-free call's")
    del st
    torch.cuda.empty_cache()
    rec["phase_s"] = time.time() - t_phase
    log(f"  phase kernels K12: {rec['checks']} checks against the plain version, "
        f"{rec['phase_s']:.1f} s")


# the autodiff estimator's paths through kernels: their configuration and the
# kernels a sweep launches (K1 the cosine term's adjoint, K6 the nearest
# lookup's value, K13 the bicubic node term, K14 and K15 the Charbonnier edges)
AUTODIFF_PATHS = {
    "tpu_fast autodiff": (GQMAPConfig.tpu_fast(gradient_estimator="autodiff"),
                          dict(K1=1, K15=1)),
    "full_mixture autodiff": (GQMAPConfig.full_mixture(gradient_estimator="autodiff"),
                              dict(K13=1, K14=1)),
    "legacy_v2 autodiff": (GQMAPConfig.legacy_v2(gradient_estimator="autodiff"),
                           dict(K6=1, K14=1)),
}
AUTODIFF_SWEEPS = 30  # each turn's graph segment, from sigma = 0.05
AUTODIFF_PLAIN_CHUNK = 27  # the plain versions' points a step in the kernel checks


def autodiff_probes(cfg, dev):
    """``k4_probes``' states (init, sigma = 0.05, the |rho| clamp) and
    ``bounds``: every mean on an integer bound of the flow range (sigma 0.05),
    so the centre node's queries of the sites at those columns and rows lie
    exactly on the frame's clamp; each with edge correlations: zero at the
    init, uniform in [-0.9, 0.9] at sigma = 0.05 and on the bounds, +-0.99999
    at the clamp."""
    probes = k4_probes(cfg, (H, W), dev)
    gen = torch.Generator().manual_seed(7)

    def rand(like):
        return torch.rand(like.shape, generator=gen, dtype=torch.float64).to(dev)

    conv = probes["converged"]
    probes["bounds"] = conv._replace(
        muu=torch.where(rand(conv.muu) < 0.5, FR[0], FR[1]),
        muv=torch.where(rand(conv.muv) < 0.5, FR[2], FR[3]))
    for name in ("converged", "bounds"):
        probes[name] = probes[name]._replace(rou=1.8 * rand(probes[name].rou) - 0.9)
    probes["clamp"] = probes["clamp"]._replace(
        rou=0.99999 * torch.where(rand(probes["clamp"].rou) < 0.5, -1.0, 1.0))
    return probes


AUTODIFF_VARIANTS = {"K13": ("v2", "v1"), "K14": ("v2", "v1"), "K15": ("v2", "v1")}  # default first
AUTODIFF_SIGMAS = (0.05, 0.5, 2.0, 3.0, 4.5)  # K13's budget table: converged .. the init's


def kernels_autodiff(dev, record, I1, I2, issue_ms):
    """Phase 18b: K13, K14 and K15 at 376x452 against their plain versions
    (float64 within 1e-10 of each sum's largest magnitude, float32 by the
    ratio rule against the float64 golden; :func:`compare_quad`'s floor) on
    :func:`autodiff_probes`' states, each in both variants
    (:data:`AUTODIFF_VARIANTS`): v2's sums v1's bit for bit on every probe
    (and in K13 v2's runtime-K and K14 v2's and K15 v2's generic instance at
    the main rule; K15 also at K1 = 25 and 13), K13
    v2's L1 route (``window_bytes=0``) its shared route's bit for bit, its
    L1-route shares; a shard's block bit for bit the whole lattice's; NaN
    and infinite probes; each variant's time beside its plain version's, its
    bound and its SASS issue bound (``issue_ms(unit, work)``); fills
    ``record["K13"]`` .. ``record["K15"]``, a record a variant under its
    name."""
    from gqmap_tpu_torch.kernels import autodiff_gq as ag
    from gqmap_tpu_torch.kernels import node_gq
    from gqmap_tpu_torch.kernels.edge_reduced_gq import neighbour_stacks
    from gqmap_tpu_torch.ops.interp import pad_cubic

    log("phase kernels K13-K15")
    t_phase = time.time()
    fm = AUTODIFF_PATHS["full_mixture autodiff"][0]
    fast = AUTODIFF_PATHS["tpu_fast autodiff"][0]
    K, k1 = fm.K, 2 * fast.K + 3
    probes = autodiff_probes(fm, dev)

    def frames(dtype):
        return (torch.as_tensor(I1, dtype=dtype, device=dev),
                pad_cubic(torch.as_tensor(I2, dtype=dtype, device=dev)))

    def operands(name, st, dtype, I1d=None):
        """(kernel, plain version, arguments) of each kernel on ``st`` (K13:
        frame 1 ``I1d`` where given)."""
        site = [x.to(dtype).contiguous() for x in (st.muu, st.muv, st.sigmau, st.sigmav, st.pn)]
        mu, sg = torch.stack(site[:2]), torch.stack(site[2:4])
        rou = st.rou.to(dtype).contiguous()
        if name == "K13":
            I1t, VV = frames(dtype)
            return (ag.node_chain_gq_cuda, ag.node_chain_gq_torch,
                    (I1t if I1d is None else I1d, VV, *site, K, fm.lambdad, fm.epsn), dict(
                        quad_chunk=AUTODIFF_PLAIN_CHUNK))
        if name == "K14":
            u2e, o2e = neighbour_stacks(mu, sg)
            return (ag.edge_chain_gq_cuda, ag.edge_chain_gq_torch,
                    (mu, sg, u2e, o2e, rou, K, fm.lambdas, fm.epsn),
                    dict(quad_chunk=AUTODIFF_PLAIN_CHUNK))
        return (ag.edge_diff_adjoint_cuda, ag.edge_diff_adjoint_torch,
                (mu, sg, rou, k1, fast.lambdas, fast.epsn), {})

    def worst_rel(xs, gold):
        return max(float((x.double() - y).abs().max() / y.abs().max()) for x, y in zip(xs, gold))

    def same(xs, ys):
        return all(same_bits(x, y) for x, y in zip(xs, ys))

    shapes = {"K13": (3, H, W), "K14": (2, 2, 3, H, W), "K15": (2, 2, 3, H, W)}
    works = {"K13": roofline.k13_work(shapes["K13"], K),
             "K14": roofline.k14_work(shapes["K14"], K),
             "K15": roofline.k15_work(shapes["K15"], k1)}
    n_sites = math.prod(shapes["K13"])
    ctas = node_gq.v2_ctas(shapes["K13"], 1)
    # the issue bound's units: K13 a lane's round of points (a site's 4 lanes
    # run ceil(K^2 / 4) rounds), K14 and K15 a point of an element
    issue_units = {"K13": n_sites * 4 * -(-K * K // 4), "K14": math.prod(shapes["K14"]) * K * K,
                   "K15": math.prod(shapes["K15"]) * k1}
    sass_units = {("K13", "v1"): "K13 v1 point", ("K13", "v2"): "K13 v2 point",
                  ("K14", "v1"): "K14 v1 point", ("K14", "v2"): "K14 v2 point",
                  ("K15", "v1"): "K15 point", ("K15", "v2"): "K15 v2 point"}
    checks = 0
    for name in ("K13", "K14", "K15"):
        variants = AUTODIFF_VARIANTS[name]
        rec = record[name] = dict(shape=list(shapes[name]), K=k1 if name == "K15" else K,
                                  variant=variants[0], v2_equals_v1_checks=0)
        recs = {v: dict(library_ms=None, library_reason=(
            "no PyTorch call computes these sums; torch.autograd of the plain version is the "
            "plain version")) for v in variants}
        if name == "K13":
            rec["l1_route_share"] = {}
        for dtype in (torch.float64, torch.float32):
            for sname, st in probes.items():
                kern, plain, args, pkw = operands(name, st, dtype)
                want = plain(*args, **pkw)
                gold = None
                if dtype == torch.float32:
                    gold = plain(*operands(name, st, torch.float64)[2], **pkw)
                outs = {}
                for variant in variants:
                    got = outs[variant] = kern(*args, variant=variant)
                    a, r, ok = compare_quad(got, want, dtype)
                    what = f"{name} {variant or ''} {shapes[name]} {str(dtype)[6:]} {sname}"
                    checks += 1
                    if dtype == torch.float64:
                        require(ok, f"{what}: max abs err {a:.3e}, rel {r:.3e}")
                    else:
                        ek, ep = worst_rel(got, gold), worst_rel(want, gold)
                        require(ek <= 2.0 * ep + 1e-6,
                                f"{what}: error vs f64 golden kernel {ek:.3e} <= 2 x plain "
                                f"{ep:.3e} + 1e-6 (kernel vs plain max abs {a:.3e}, rel "
                                f"{r:.3e})")
                        if sname == "converged":
                            recs[variant]["max_abs_err"] = a
                if len(variants) > 1:
                    # v2 is v1 bit for bit, in the other instance at the main rule too
                    other = kern(*args, variant="v2", generic=True)
                    rec["v2_equals_v1_checks"] += 1
                    require(same(outs["v2"], outs["v1"]) and same(other, outs["v1"]),
                            f"{name} {str(dtype)[6:]} {sname}: v2's sums v1's bit for bit (the "
                            "main rule's instance and the generic one)")
                if name == "K15":
                    # K15 v2 at the super presets' K1 = 25 (its instance and the
                    # generic one) and at K1 = 13 (generic): v1's outputs bit for bit
                    for rule in (25, 13):
                        a = (*args[:3], rule, *args[4:])
                        v1 = kern(*a, variant="v1")
                        rec["v2_equals_v1_checks"] += 1
                        require(same(kern(*a, variant="v2"), v1)
                                and same(kern(*a, variant="v2", generic=True), v1),
                                f"K15 {str(dtype)[6:]} {sname} K1 = {rule}: v2's outputs v1's "
                                "bit for bit (its instance and the generic one)")
                if name == "K13":
                    # the L1 route (a budget of 0): every CTA and site, the same bits
                    cnt = torch.zeros(2, dtype=torch.int64, device=dev)
                    every = torch.zeros(2, dtype=torch.int64, device=dev)
                    shared = kern(*args, l1_counts=cnt)
                    l1 = kern(*args, window_bytes=0, l1_counts=every)
                    require(same(shared, outs["v2"]) and same(l1, shared)
                            and every.tolist() == [ctas, n_sites],
                            f"K13 v2 {str(dtype)[6:]} {sname}: the L1 route's sums the shared "
                            f"route's bit for bit, counts {every.tolist()} (want {[ctas, n_sites]})")
                    rec["l1_route_share"][f"{str(dtype)[6:]} {sname}"] = dict(
                        ctas=int(cnt[0]) / ctas, sites=int(cnt[1]) / n_sites)
                del want, gold, outs
        torch.cuda.empty_cache()
        if name == "K13":
            log(f"  K13 v2 L1-route shares (CTAs with no window, sites read through L1) by "
                f"probe: {rec['l1_route_share']}")

        # a shard's block: K13 at its pixel origin, K15 with its halo, K14 on
        # its block's operands: the whole lattice's sums there, bit for bit
        st = probes["converged"]
        for variant in variants:
            for dtype in (torch.float64, torch.float32):
                kern, plain, args, pkw = operands(name, st, dtype)
                whole = kern(*args, variant=variant)
                r0, c0, m, n = H // 10, W // 9, H // 4 + 7, W // 2 - 23  # odd offsets
                blk = (Ellipsis, slice(r0, r0 + m), slice(c0, c0 + n))
                if name == "K13":
                    got = kern(*args[:2], *[x[blk].contiguous() for x in args[2:7]], *args[7:],
                               origin=(r0, c0), local_image_shape=(m, n), variant=variant)
                elif name == "K14":
                    got = kern(*[x[blk].contiguous() for x in args[:5]], *args[5:],
                               variant=variant)
                else:
                    mu, sg, rou = args[:3]
                    ms = torch.stack([mu, sg])
                    halo = (ms[..., r0 + m:r0 + m + 1, c0:c0 + n].contiguous(),
                            ms[..., r0:r0 + m, c0 + n:c0 + n + 1].contiguous())
                    got = kern(*[x[blk].contiguous() for x in (mu, sg, rou)], *args[3:],
                               halo=halo, variant=variant)
                require(all(torch.equal(g, w[blk]) for g, w in zip(got, whole)),
                        f"{name} {variant or ''} {str(dtype)[6:]} block of ({m}, {n}) sites at "
                        f"({r0}, {c0}): the whole lattice's sums there, bit for bit")

        # NaN inputs at a few sites: NaN exactly where the plain version's is,
        # every other element bit for bit the NaN-free call's; infinite inputs
        # (frame 1 and the state: root() gives NaN at +inf): v2 is v1 bit for bit
        for dtype in (torch.float64, torch.float32):
            bad = st._replace(muu=st.muu.clone(), pn=st.pn.clone(), rou=st.rou.clone())
            bad.muu[0, H // 4, W // 5] = float("nan")
            bad.pn[2, H - 1, W - 1] = float("nan")
            bad.rou[1, 0, 1, H // 2, W // 3] = float("nan")
            kern, plain, args, pkw = operands(name, bad, dtype)
            want = plain(*args, **pkw)
            clean_args = operands(name, st, dtype)[2]
            for variant in variants:
                got = kern(*args, variant=variant)
                clean = kern(*clean_args, variant=variant)
                ok = all(bool(torch.isnan(w).any())
                         and torch.equal(torch.isnan(g), torch.isnan(w))
                         and torch.equal(g[~torch.isnan(w)], c[~torch.isnan(w)])
                         for g, w, c in zip(got, want, clean))
                require(ok, f"{name} {variant or ''} {str(dtype)[6:]} NaN probes: NaN exactly "
                            "where the plain version's is, every other element bit for bit the "
                            "NaN-free call's")
            if len(variants) > 1:
                inf = st._replace(muu=st.muu.clone(), sigmav=st.sigmav.clone())
                inf.muu[1, H // 3, W // 7] = float("inf")
                inf.sigmav[0, 5, 9] = float("inf")
                I1d = frames(dtype)[0].clone()
                I1d[H // 2, W // 2] = float("inf")
                kern, _, args, _ = operands(name, inf, dtype, I1d)
                v1 = kern(*args, variant="v1")
                rec["v2_equals_v1_checks"] += 1
                require(not all(bool(torch.isfinite(x).all()) for x in v1)
                        and same(kern(*args, variant="v2"), v1),
                        f"{name} {str(dtype)[6:]} infinite inputs: v2's sums v1's bit for bit")
                # quotients below div_fast's range: K14 and K15 on neighbours 1e-25
                # apart with sigma 1e-27, K13 at eps = 0 (v2 takes v1's division
                # throughout)
                kern, _, args, _ = operands(name, st, dtype)
                if name in ("K14", "K15"):
                    g = torch.Generator().manual_seed(5)
                    mu = torch.round(args[0] * 4) / 4 + 1e-25 * torch.randint(
                        -1, 2, args[0].shape, generator=g).to(dev, dtype)
                    sg = torch.full_like(args[1], 1e-27)
                    args = ((mu, sg, *neighbour_stacks(mu, sg), *args[4:]) if name == "K14"
                            else (mu, sg, *args[2:]))
                else:
                    args = (*args[:9], 0.0)
                v1 = kern(*args, variant="v1")
                rec["v2_equals_v1_checks"] += 1
                require(same(kern(*args, variant="v2"), v1),
                        f"{name} {str(dtype)[6:]} quotients below the fast division's range: "
                        "v2's sums v1's bit for bit")

        # times (float32, sigma = 0.05; K13 also from the init) in turns, beside
        # the plain version's, the bound and the SASS issue bound
        kern, plain, args, pkw = operands(name, st, torch.float32)
        plain_ms = time_ms(lambda: plain(*args, **pkw), 2)
        iargs = operands(name, probes["init"], torch.float32)[2]
        for variant in variants:
            r = recs[variant]
            r["ms"], r["ms_min"] = kernel_ms(lambda: kern(*args, variant=variant))
            if name == "K13":
                r["init_ms"], _ = kernel_ms(lambda: kern(*iargs, variant=variant))
            if (name, variant) == ("K13", "v2"):  # its L1 route (a budget of 0)
                r["l1_route_ms"], _ = kernel_ms(lambda: kern(*args, window_bytes=0))
                r["init_l1_route_ms"], _ = kernel_ms(lambda: kern(*iargs, window_bytes=0))
            r["plain_ms"] = plain_ms
            r.update(bound(works[name]))
            r["share"] = dict(sheet=r["bound_ms"] / r["ms"],
                              measured=r["bound_ms_measured"] / r["ms"])
            r["sass_issue_ms"] = issue_ms(sass_units[name, variant], issue_units[name])
        for variant in variants[::-1]:  # and again, in the other order
            r = recs[variant]
            r["ms_again"], _ = kernel_ms(lambda: kern(*args, variant=variant))
        if name == "K13":
            # K13 v2's window budget (the default, K4 v2's; 12 KB, which sends the
            # tiles of wide sites through L1; 0: every site through L1) against v1,
            # on the probes and as sigma widens from sigma = 0.05's state
            table = rec["window_budget_ms"] = {}
            budgets = {"default": None, "12 KB": 12 * 1024, "L1": 0}
            cases = {p: operands(name, probes[p], torch.float32)[2] for p in ("init", "clamp")}
            for sig in AUTODIFF_SIGMAS:
                cases[f"sigma {sig}"] = (*args[:4], torch.full_like(args[4], sig),
                                         torch.full_like(args[5], sig), *args[6:])
            for case, ca in cases.items():
                row = table[case] = {"v1": kernel_ms(lambda: kern(*ca, variant="v1"))[0]}
                for label, wb in budgets.items():
                    cnt = torch.zeros(2, dtype=torch.int64, device=dev)
                    kern(*ca, window_bytes=wb, l1_counts=cnt)
                    row[f"v2 {label}"] = kernel_ms(lambda: kern(*ca, window_bytes=wb))[0]
                    row[f"v2 {label} L1 sites"] = int(cnt[1]) / n_sites
            log(f"  K13 by window budget (ms; v1; v2 at the default "
                f"{node_gq.window_budget(K, torch.float32)} B, at 12 KB, through L1 alone; and "
                f"v2's share of sites read through L1): {table}")
        for variant in variants:
            r = recs[variant]
            issue = r["sass_issue_ms"]
            log(f"  {name} {variant or ''} {shapes[name]} f32 on "
                f"{smi('name,power.limit,clocks.sm')} (median, min) of {TIMING[0]} windows of "
                f"{TIMING[1]} calls: ({r['ms']:.4f}, {r['ms_min']:.4f}) ms, again "
                f"{r['ms_again']:.4f}" + (f", from init {r['init_ms']:.4f}" if "init_ms" in r
                                          else "") +
                (f"; L1 route alone {r['l1_route_ms']:.4f}, from init "
                 f"{r['init_l1_route_ms']:.4f}" if "l1_route_ms" in r else "") +
                f"; plain {r['plain_ms']:.4f} ms ({r['plain_ms'] / r['ms']:.0f}x); "
                f"{fmt_bound(r)} ({r['bound_terms_ms']}); share of the bound: data sheet "
                f"{r['share']['sheet']:.1%}, measured {r['share']['measured']:.1%}; SASS issue "
                f"bound {issue if issue is None else f'{issue:.4f}'} ms"
                + ("" if issue is None else f" ({issue / r['ms']:.1%})"))
        rec.update(recs)
        del args, iargs
        torch.cuda.empty_cache()
    del probes
    record["K13"]["phase_s"] = time.time() - t_phase
    v2_checks = sum(record[k]["v2_equals_v1_checks"] for k in ("K13", "K14", "K15"))
    log(f"  phase kernels K13-K15: {checks} checks against the plain versions, {v2_checks} of "
        f"v2 against v1, {time.time() - t_phase:.1f} s")


def autodiff_segments(dev, record, by_path, kfns):
    """Phase 18c: the three autodiff paths of :data:`AUTODIFF_PATHS` at
    376x452 f32 through the user's entry point (``make_segment_runner``, the
    graph route, the backward captured with the sweep): one sweep of each
    from the init and from sigma = 0.05 through the kernels and through the
    plain route (``node_kernel = edge_kernel = "torch"``: ``torch.autograd``
    of the plain expectation) against the float64 golden (the plain route in
    float64; the kernels' error at most twice the plain route's); then
    :data:`AUTODIFF_SWEEPS`-sweep graph segments from sigma = 0.05 in turns
    (the kernels with K13, K14 and K15 in v2, v1 and v2 again, then the
    plain route): ms a sweep by CUDA events, the
    capturing call's peak memory, and the kernels a replay launches
    (counters 0 just before each timed segment, read after): the path's
    kernels once a sweep through the kernels in either variant, none through
    the plain route."""
    from gqmap_tpu_torch import FlowRange
    from gqmap_tpu_torch.kernels import autodiff_gq as ag
    from gqmap_tpu_torch.models import gqmap as pg

    log("phase autodiff segments")
    t_phase = time.time()
    I1, I2, _ = synthetic_pair()
    fr = FlowRange(*FR)
    plain_routes = dict(node_kernel="torch", edge_kernel="torch")
    out = record["autodiff"] = {"card": smi("name,power.limit")}

    def zero():
        torch.cuda.synchronize()
        for f in kfns.values():
            f.launches = 0

    def cast(st, dtype):
        return pg.GQState(*(x.to(dtype) if x.is_floating_point() else x for x in st))

    for path, (base, want) in AUTODIFF_PATHS.items():
        rec = out[path] = {}
        cfg = dataclasses.replace(base, its=100000, eval_every=AUTODIFF_SWEEPS, tor=0.0)
        c64 = dataclasses.replace(cfg, dtype="float64")
        probs = {torch.float32: pg.make_problem(cfg, I1, I2, fr, dev),
                 torch.float64: pg.make_problem(c64, I1, I2, fr, dev)}
        st64 = pg.init_state(c64, fr, (H, W), seed=0, device=dev)
        conv64 = st64._replace(sigmau=torch.full_like(st64.sigmau, 0.05),
                               sigmav=torch.full_like(st64.sigmav, 0.05))
        three_way_sweep(f"{path} ", pg.make_sweep(dataclasses.replace(c64, **plain_routes),
                                                  (H, W)),
                        pg.make_sweep(dataclasses.replace(cfg, **plain_routes), (H, W)),
                        pg.make_sweep(cfg, (H, W)), probs,
                        (("init", st64), ("converged", conv64)), cast)
        del probs[torch.float64]
        problem = probs[torch.float32]
        start = cast(conv64, torch.float32)
        # K13, K14 and K15 through v2 (the default), v1 and v2 again, then the plain route
        turns = [("v2", {}, "v2"), ("v1", {}, "v1"), ("v2 again", {}, "v2"),
                 ("plain", plain_routes, "v2")]
        for turn, routes, variant in turns:
            ag._DEFAULT_VARIANT = variant
            tcfg = dataclasses.replace(cfg, **routes)
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            held = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            seg = pg.make_segment_runner(tcfg, (H, W))
            seg(problem, start, 1)  # the capture
            peak = (torch.cuda.max_memory_allocated() - held) / 2**30
            zero()
            t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t0.record()
            res = seg(problem, start, AUTODIFF_SWEEPS)
            t1.record()
            torch.cuda.synchronize()
            counts = {k: f.launches for k, f in kfns.items()}
            ms = t0.elapsed_time(t1) / AUTODIFF_SWEEPS
            finite = all(bool(torch.isfinite(x).all()) for x in res[0])
            expect = launch_counts(**({k: v * AUTODIFF_SWEEPS for k, v in want.items()}
                                      if not routes else {}))
            by_path[f"{path} {turn} ({AUTODIFF_SWEEPS} sweeps)"] = counts
            rec[turn] = dict(ms_a_sweep=ms, capture_peak_GiB=peak, capture_s=seg.capture_s,
                             launches=counts, kernels_a_replay=sum(counts.values())
                             / AUTODIFF_SWEEPS)
            require(seg.route == "graph" and res[1] == AUTODIFF_SWEEPS and finite
                    and counts == expect,
                    f"{path} {turn}: route {seg.route!r}, {res[1]} sweeps, finite state, "
                    f"launches {counts} (want {expect})")
            log(f"  {path} {turn} on {out['card']}: {ms:.4f} ms a sweep ({AUTODIFF_SWEEPS}-sweep "
                f"graph segment from sigma 0.05), capture {seg.capture_s:.3f} s at a peak of "
                f"{peak:.3f} GiB above what was held")
            del seg, res
        ag._DEFAULT_VARIANT = "v2"
        del problem, probs
        torch.cuda.empty_cache()
    out["phase_s"] = time.time() - t_phase
    log(f"  phase autodiff segments {out['phase_s']:.1f} s")


# the autodiff estimator's windowed and super-lattice bicubic node terms:
# their configuration and the kernels a sweep launches (K16 the windowed
# term, K13 at patch 4 the super lattice's; K14 the Charbonnier edges)
CHAIN_PATHS = {
    "full_mixture window_rg=2 autodiff": (
        GQMAPConfig.full_mixture(window_rg=2, gradient_estimator="autodiff"), dict(K14=1, K16=1)),
    "legacy_v2 bicubic autodiff": (
        GQMAPConfig.legacy_v2(data_term="bicubic", gradient_estimator="autodiff"),
        dict(K14=1, K16=1)),
    "super_entropy autodiff": (GQMAPConfig.super_entropy(gradient_estimator="autodiff"),
                               dict(K13=1, K14=1)),
}
# the frames the plain route is tried on, largest first (each divisible by
# the super lattice's patch): under autograd it keeps every window tap's
# intermediates, which need more than the card's memory at full width
CHAIN_FRAMES = ((H, W), (188, 224), (128, 160), (96, 112))
CHAIN_PLAIN_SWEEPS = 5  # the plain route's turn: hundreds of ms a sweep
CHAIN_SMALL_WINDOW = 2048  # a window budget the shifted copies do not fit, one copy does


def chain_case(path):
    """K16's or K13's (at patch 4) kernel, plain version, extra arguments and
    keywords on ``path``'s configuration (K16: the radius; K13: the patch)."""
    from gqmap_tpu_torch.kernels import autodiff_gq as ag

    cfg = CHAIN_PATHS[path][0]
    if cfg.window_rg:
        return (ag.node_window_chain_gq_cuda, ag.node_window_chain_gq_torch, (cfg.window_rg,),
                {})
    return ag.node_chain_gq_cuda, ag.node_chain_gq_torch, (), dict(patch=cfg.patch)


def fitting_frame(fn, label):
    """The largest frame of :data:`CHAIN_FRAMES` where ``fn(frame)`` runs
    within the card's memory, and what it returned there; each frame that
    ran out is printed."""
    for frame in CHAIN_FRAMES:
        try:
            return frame, fn(frame)
        except torch.cuda.OutOfMemoryError as err:
            log(f"  {label} at {frame}: out of the card's memory ({str(err).splitlines()[0]})")
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
    raise RuntimeError(f"{label}: runs out of memory on every frame of {CHAIN_FRAMES}")


def kernels_chain_block(dev, record, I1, I2, issue_ms):
    """Phase 18e: K16 (``full_mixture(window_rg=2)``'s (3, 376, 452) sites and
    ``legacy_v2(data_term="bicubic")``'s (1, 376, 452), K = 9, rg = 2) and
    K13 at patch 4 (``super_entropy``'s (3, 94, 113), K = 11) against their
    plain versions on :func:`autodiff_probes`' states (float64 within 1e-10
    of each sum's largest magnitude, float32 by the ratio rule against the
    float64 golden); every route bit for bit the default one (the window as
    one copy, VV through L1 with its counts, the runtime-K instance); a
    shard's block bit for bit the whole lattice's; NaN probes; the instances'
    registers, local memory and CTAs an SM; each case's time (sigma = 0.05
    and from the init) beside its plain version's, its bound
    (``roofline.k16_work``, ``k13_work(patch=4)``) and its SASS issue bound.
    Fills ``record["K16"]`` (the main path's case at its top, the other
    under its path) and ``record["K13"]["patch 4"]``."""
    from gqmap_tpu_torch.kernels import autodiff_gq as ag
    from gqmap_tpu_torch.ops.interp import pad_cubic

    log("phase kernels K16, K13 at patch 4")
    t_phase = time.time()

    def frames(dtype):
        return (torch.as_tensor(I1, dtype=dtype, device=dev),
                pad_cubic(torch.as_tensor(I2, dtype=dtype, device=dev)))

    def worst_rel(xs, gold):
        return max(float((x.double() - y).abs().max() / y.abs().max()) for x, y in zip(xs, gold))

    def same(xs, ys):
        return all(same_bits(x, y) for x, y in zip(xs, ys))

    rec16 = record["K16"] = dict(variant="v1", library_ms=None, library_reason=(
        "no PyTorch call computes these sums: grid_sample's bicubic uses a = -0.75, not "
        "MATLAB's -0.5, and gives no derivative sums; torch.autograd of the plain version is "
        "the plain version"))
    checks = 0
    for path in CHAIN_PATHS:
        cfg = CHAIN_PATHS[path][0]
        kern, plain, extra, kw = chain_case(path)
        name = "K16" if cfg.window_rg else "K13 patch 4"
        probes = autodiff_probes(cfg, dev)
        shape = tuple(probes["init"].muu.shape)
        n_sites = math.prod(shape)
        rg = cfg.window_rg
        G = ag.chain_tile(rg)[0]
        ctas = ag.chain_ctas(shape, rg)

        def operands(st, dtype, I1d=None):
            site = [x.to(dtype).contiguous() for x in (st.muu, st.muv, st.sigmau, st.sigmav,
                                                        st.pn)]
            I1t, VV = frames(dtype)
            return (I1t if I1d is None else I1d, VV, *site, cfg.K, cfg.lambdad, cfg.epsn, *extra)

        rec = dict(shape=list(shape), K=cfg.K, rg=rg, patch=cfg.patch, l1_route_share={})
        gold = {}
        for dtype in (torch.float64, torch.float32):
            for sname, st in probes.items():
                args = operands(st, dtype)
                want = plain(*args, **kw, quad_chunk=AUTODIFF_PLAIN_CHUNK)
                got = kern(*args, **kw)
                a, r, ok = compare_quad(got, want, dtype)
                what = f"{name} {path} {shape} {str(dtype)[6:]} {sname}"
                checks += 1
                if dtype == torch.float64:
                    gold[sname] = want
                    require(ok, f"{what}: max abs err {a:.3e}, rel {r:.3e}")
                else:
                    ek, ep = worst_rel(got, gold[sname]), worst_rel(want, gold[sname])
                    require(ek <= 2.0 * ep + 1e-6,
                            f"{what}: error vs f64 golden kernel {ek:.3e} <= 2 x plain {ep:.3e} "
                            f"+ 1e-6 (kernel vs plain max abs {a:.3e}, rel {r:.3e})")
                    if sname == "converged":
                        rec["max_abs_err"] = a
                # every route the default one's bits: VV through L1 (every CTA and
                # site counted), the window as one copy, the runtime-K instance
                cnt = torch.zeros(2, dtype=torch.int64, device=dev)
                every = torch.zeros(2, dtype=torch.int64, device=dev)
                base = kern(*args, **kw, l1_counts=cnt)
                l1 = kern(*args, **kw, window_bytes=0, l1_counts=every)
                one = kern(*args, **kw, window_bytes=CHAIN_SMALL_WINDOW)
                generic = kern(*args, **kw, generic=True)
                require(same(base, got) and same(l1, got) and same(one, got)
                        and same(generic, got) and every.tolist() == [ctas, n_sites],
                        f"{what}: the L1 route, one copy and the runtime-K instance give the "
                        f"default route's sums bit for bit, L1 counts {every.tolist()} (want "
                        f"{[ctas, n_sites]})")
                rec["l1_route_share"][f"{str(dtype)[6:]} {sname}"] = dict(
                    ctas=int(cnt[0]) / ctas, sites=int(cnt[1]) / n_sites)
                del want, got, base, l1, one, generic
            torch.cuda.empty_cache()
        del gold

        # a shard's block (frame 1 at its pixel origin) and NaN inputs
        st = probes["converged"]
        P = cfg.patch
        for dtype in (torch.float64, torch.float32):
            args = operands(st, dtype)
            whole = kern(*args, **kw)
            r0, c0 = shape[1] // 10, shape[2] // 9  # odd offsets and extents
            m = min(shape[1] // 4 + 7, shape[1] - r0 - 1)
            n = max(shape[2] // 2 - 23, shape[2] // 3)
            blk = (Ellipsis, slice(r0, r0 + m), slice(c0, c0 + n))
            got = kern(*args[:2], *[x[blk].contiguous() for x in args[2:7]], *args[7:], **kw,
                       origin=(r0 * P, c0 * P), local_image_shape=(m * P, n * P))
            require(all(torch.equal(g, w[blk]) for g, w in zip(got, whole)),
                    f"{name} {str(dtype)[6:]} block of ({m}, {n}) sites at ({r0}, {c0}): the "
                    "whole lattice's sums there, bit for bit")
            bad = st._replace(muu=st.muu.clone(), pn=st.pn.clone())
            bad.muu[0, shape[1] // 4, shape[2] // 5] = float("nan")
            bad.pn[-1, shape[1] - 1, shape[2] - 1] = float("nan")
            bargs = operands(bad, dtype)
            got = kern(*bargs, **kw)
            want = plain(*bargs, **kw, quad_chunk=AUTODIFF_PLAIN_CHUNK)
            ok = all(bool(torch.isnan(w).any()) and torch.equal(torch.isnan(g), torch.isnan(w))
                     and torch.equal(g[~torch.isnan(w)], c[~torch.isnan(w)])
                     for g, w, c in zip(got, want, whole))
            require(ok, f"{name} {str(dtype)[6:]} NaN probes: NaN exactly where the plain "
                        "version's is, every other site bit for bit the NaN-free call's")
            del whole, got, want

        # times (float32) from sigma = 0.05 and from the init, beside the plain
        # version's, the bound and the SASS issue bound
        args = operands(st, torch.float32)
        iargs = operands(probes["init"], torch.float32)
        rec["ms"], rec["ms_min"] = kernel_ms(lambda: kern(*args, **kw))
        rec["init_ms"], _ = kernel_ms(lambda: kern(*iargs, **kw))
        rec["l1_route_ms"], _ = kernel_ms(lambda: kern(*args, **kw, window_bytes=0))
        rec["plain_ms"] = time_ms(lambda: plain(*args, **kw, quad_chunk=AUTODIFF_PLAIN_CHUNK), 1)
        rec["ms_again"], _ = kernel_ms(lambda: kern(*args, **kw))
        work = (roofline.k16_work(shape, cfg.K, rg) if rg
                else roofline.k13_work(shape, cfg.K, patch=P))
        rec.update(bound(work))
        rec["share"] = dict(sheet=rec["bound_ms"] / rec["ms"],
                            measured=rec["bound_ms_measured"] / rec["ms"])
        unit = "K16 point" if rg else "K13 p4 point"
        rec["sass_issue_ms"] = issue_ms(unit, n_sites * G * -(-cfg.K ** 2 // G))
        issue = rec["sass_issue_ms"]
        log(f"  {name} {path} {shape} f32 on {smi('name,power.limit,clocks.sm')} (median, min) "
            f"of {TIMING[0]} windows of {TIMING[1]} calls: ({rec['ms']:.4f}, "
            f"{rec['ms_min']:.4f}) ms, again {rec['ms_again']:.4f}, from init "
            f"{rec['init_ms']:.4f}, L1 route alone {rec['l1_route_ms']:.4f}; plain "
            f"{rec['plain_ms']:.4f} ms ({rec['plain_ms'] / rec['ms']:.0f}x); {fmt_bound(rec)} "
            f"({rec['bound_terms_ms']}); share of the bound: data sheet "
            f"{rec['share']['sheet']:.1%}, measured {rec['share']['measured']:.1%}; SASS issue "
            f"bound {issue if issue is None else f'{issue:.4f}'} ms"
            + ("" if issue is None else f" ({issue / rec['ms']:.1%})")
            + f"; L1-route shares {rec['l1_route_share']}")
        if not rg:
            record["K13"]["patch 4"] = rec
        elif path.startswith("full_mixture"):
            rec16.update(rec)
        else:
            rec16[path] = rec
        del probes, args, iargs
        torch.cuda.empty_cache()

    # the instances: registers, local memory (none) and CTAs an SM at the
    # default window budget, K16 at every radius (K = 9's and the runtime-K
    # one) and K13 at patch 4 (K = 11's and the runtime-K one)
    inst = rec16["instances"] = {}
    for dtype in (torch.float32, torch.float64):
        for rg in (0, 1, 2, 3, 4):
            K = 11 if rg == 0 else 9
            for generic in (False, True):
                occ = ag.occupancy(K, rg, dtype, generic=generic, device=dev)
                label = (f"{'K13 patch 4' if rg == 0 else f'K16 rg={rg}'} K={K}"
                         f"{' generic' if generic else ''} {str(dtype)[6:]}")
                inst[label] = occ
                require(occ["local_bytes"] == 0 and occ["ctas_per_sm"] >= 1,
                        f"{label}: no local memory, at least one CTA an SM ({occ})")
    log(f"  K16 and K13 at patch 4 instances: {inst}")
    rec16["checks"] = checks
    rec16["phase_s"] = time.time() - t_phase
    log(f"  phase kernels K16, K13 at patch 4: {checks} checks against the plain versions, "
        f"{rec16['phase_s']:.1f} s")


def chain_block_segments(dev, record, by_path, kfns):
    """Phase 18f: the three paths of :data:`CHAIN_PATHS` through the user's
    entry point (``make_segment_runner``, the graph route). One sweep from
    the init and from sigma = 0.05 three ways (kernels f32, plain route f32,
    plain route f64 = the golden; the kernels' error at most twice the plain
    route's) on the largest frame of :data:`CHAIN_FRAMES` where the golden
    fits; then graph segments in turns from sigma = 0.05: the kernels at
    376x452 (:data:`AUTODIFF_SWEEPS` sweeps), the plain route
    (``node_kernel = edge_kernel = "torch"``, :data:`CHAIN_PLAIN_SWEEPS`
    sweeps) on the largest frame where it fits, printed, and the kernels
    again: ms a sweep by CUDA events, the capturing call's peak memory above
    what was held, and the kernels a replay launches (counters 0 just before
    each timed segment, read after: the path's kernels once a sweep, none on
    the plain route)."""
    from gqmap_tpu_torch import FlowRange
    from gqmap_tpu_torch.models import gqmap as pg

    log("phase autodiff window and super segments")
    t_phase = time.time()
    I1, I2, _ = synthetic_pair()
    fr = FlowRange(*FR)
    plain_routes = dict(node_kernel="torch", edge_kernel="torch")
    out = record["autodiff_window"] = {"card": smi("name,power.limit")}

    def zero():
        torch.cuda.synchronize()
        for f in kfns.values():
            f.launches = 0

    def cast(st, dtype):
        return pg.GQState(*(x.to(dtype) if x.is_floating_point() else x for x in st))

    def converged(cfg, frame):
        st = pg.init_state(cfg, fr, frame, seed=0, device=dev)
        return st._replace(sigmau=torch.full_like(st.sigmau, 0.05),
                           sigmav=torch.full_like(st.sigmav, 0.05))

    def segment(cfg, frame, sweeps):
        """A graph segment of ``sweeps`` sweeps from sigma = 0.05 on ``frame``:
        ms a sweep, capture peak (GiB above what was held), launches."""
        problem = pg.make_problem(cfg, I1[:frame[0], :frame[1]], I2[:frame[0], :frame[1]], fr,
                                  dev)
        start = converged(cfg, frame)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        seg = pg.make_segment_runner(cfg, frame)
        try:
            seg(problem, start, 1)  # the capture
            peak = (torch.cuda.max_memory_allocated() - held) / 2**30
            zero()
            t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t0.record()
            res = seg(problem, start, sweeps)
            t1.record()
            torch.cuda.synchronize()
            finite = all(bool(torch.isfinite(x).all()) for x in res[0])
            return dict(ms_a_sweep=t0.elapsed_time(t1) / sweeps, capture_peak_GiB=peak,
                        capture_s=seg.capture_s, route=seg.route, sweeps=res[1], finite=finite,
                        launches={k: f.launches for k, f in kfns.items()}, frame=list(frame))
        finally:
            del seg, problem, start
            torch.cuda.empty_cache()

    for path, (base, want) in CHAIN_PATHS.items():
        rec = out[path] = {}
        cfg = dataclasses.replace(base, its=100000, eval_every=AUTODIFF_SWEEPS, tor=0.0)
        c64 = dataclasses.replace(cfg, dtype="float64", **plain_routes)

        # one sweep three ways where the golden fits
        def golden(frame):
            prob = pg.make_problem(c64, I1[:frame[0], :frame[1]], I2[:frame[0], :frame[1]], fr,
                                   dev)
            sweep = pg.make_sweep(c64, frame)
            init = pg.init_state(c64, fr, frame, seed=0, device=dev)
            states = (("init", init), ("converged", converged(c64, frame)))
            for _, st in states:  # the golden fits where both its sweeps run
                sweep(prob, st)
            return prob, sweep, states

        frame, (p64, gold, states) = fitting_frame(golden, f"{path} f64 plain sweep")
        rec["three_way_frame"] = list(frame)
        probs = {torch.float64: p64, torch.float32: pg.make_problem(
            cfg, I1[:frame[0], :frame[1]], I2[:frame[0], :frame[1]], fr, dev)}
        three_way_sweep(f"{path} {frame} ", gold,
                        pg.make_sweep(dataclasses.replace(cfg, **plain_routes), frame),
                        pg.make_sweep(cfg, frame), probs, states, cast)
        del probs, p64, gold, states
        torch.cuda.empty_cache()

        # graph segments in turns: kernels, plain route (largest frame it fits), kernels
        for turn in ("kernels", "plain", "kernels again"):
            if turn == "plain":
                frame, r = fitting_frame(
                    lambda f: segment(dataclasses.replace(cfg, **plain_routes), f,
                                      CHAIN_PLAIN_SWEEPS), f"{path} plain route segment")
                expect = launch_counts()
                sweeps = CHAIN_PLAIN_SWEEPS
            else:
                frame, r = (H, W), segment(cfg, (H, W), AUTODIFF_SWEEPS)
                expect = launch_counts(**{k: v * AUTODIFF_SWEEPS for k, v in want.items()})
                sweeps = AUTODIFF_SWEEPS
            rec[turn] = r
            by_path[f"{path} {turn} ({sweeps} sweeps)"] = r["launches"]
            require(r["route"] == "graph" and r["sweeps"] == sweeps and r["finite"]
                    and r["launches"] == expect,
                    f"{path} {turn} at {frame}: route {r['route']!r}, {r['sweeps']} sweeps, "
                    f"finite state, launches {r['launches']} (want {expect})")
            log(f"  {path} {turn} on {out['card']} at {frame}: {r['ms_a_sweep']:.4f} ms a sweep "
                f"({sweeps}-sweep graph segment from sigma 0.05), capture {r['capture_s']:.3f} s "
                f"at a peak of {r['capture_peak_GiB']:.3f} GiB above what was held")
    out["phase_s"] = time.time() - t_phase
    log(f"  phase autodiff window and super segments {out['phase_s']:.1f} s")


D7_PRESETS = ("tpu_fast", "tpu_fast_super")  # at L = 5: K1 in two groups of components
D7_CROP = (64, 80)  # full_mixture(K=65)'s frame: its plain sums take 4,225 points a site


def d7_phase(dev, record, by_path, kfns):
    """Phase 18d: configurations the JAX package runs past a kernel's shape
    limit run on the card. ``tpu_fast(L=5)`` and ``tpu_fast_super(L=5)``
    under the Stein and the autodiff estimators: one 376x452 sweep from the
    init and from sigma = 0.05 three ways (:func:`three_way_sweep`: kernels
    f32 on ``"auto"``, plain f32, plain f64), then one counted sweep that
    launches K1 once a group of components (``cosine_gq.component_groups``:
    3 + 2) and K2 (Stein) or K15 (autodiff) once; K1 at L = 5 held to the
    plain full sums (float64 within 1e-10, float32 within phase 3's
    tolerance) and timed against L = 3 on the same field. ``full_mixture(K=65)``
    on a crop, past K4's and K3's limits: one sweep on ``"auto"`` that is
    finite and launches no kernel, and ``check_supported`` refusing
    ``"cuda"`` for each term with the limit named."""
    from gqmap_tpu_torch import FlowRange, GQMAPConfig
    from gqmap_tpu_torch.kernels import cosine_gq
    from gqmap_tpu_torch.models import gqmap as pg

    log("phase D7")
    t_phase = time.time()
    I1, I2, _ = synthetic_pair()
    fr = FlowRange(*FR)
    out = record["D7"] = {"card": smi("name,power.limit")}
    plain = dict(node_kernel="torch", edge_kernel="torch")
    groups = len(cosine_gq.component_groups(5))

    def cast(st, dtype):
        return pg.GQState(*(x.to(dtype) if x.is_floating_point() else x for x in st))

    def zero():
        torch.cuda.synchronize()
        for f in kfns.values():
            f.launches = 0

    for preset in D7_PRESETS:
        base = getattr(GQMAPConfig, preset)(L=5, its=300, eval_every=300)
        c64 = dataclasses.replace(base, dtype="float64")
        probs = {torch.float32: pg.make_problem(base, I1, I2, fr, dev),
                 torch.float64: pg.make_problem(c64, I1, I2, fr, dev)}
        st64 = pg.init_state(c64, fr, (H, W), seed=0, device=dev)
        conv64 = st64._replace(sigmau=torch.full_like(st64.sigmau, 0.05),
                               sigmav=torch.full_like(st64.sigmav, 0.05))
        rec = out[preset] = {}
        for est in ("stein", "autodiff"):
            cfg = dataclasses.replace(base, gradient_estimator=est)
            cfg64 = dataclasses.replace(cfg, dtype="float64")
            three_way_sweep(f"{preset}(L=5) {est} ",
                            pg.make_sweep(dataclasses.replace(cfg64, **plain), (H, W)),
                            pg.make_sweep(dataclasses.replace(cfg, **plain), (H, W)),
                            pg.make_sweep(cfg, (H, W)), probs,
                            (("init", st64), ("converged", conv64)), cast)
            sweep = pg.make_sweep(cfg, (H, W))
            zero()
            st, aux = sweep(probs[torch.float32], cast(conv64, torch.float32))
            torch.cuda.synchronize()
            counts = {k: f.launches for k, f in kfns.items()}
            by_path[f"{preset}(L=5) {est} (one sweep)"] = counts
            want = launch_counts(K1=groups, **{"K15" if est == "autodiff" else "K2": 1})
            finite = all(bool(torch.isfinite(x).all()) for x in st if x.is_floating_point())
            require(finite and bool(torch.isfinite(aux.energy)) and counts == want,
                    f"{preset}(L=5) {est}: one sweep on 'auto', finite state, launches {counts} "
                    f"(want {want}: K1 once a group of {cosine_gq.component_groups(5)})")
        # K1 in groups against the plain full sums, and its time at L = 5 and L = 3
        for dtype in (torch.float64, torch.float32):
            s = cast(conv64, dtype)
            p = probs[dtype]
            sites = (s.muu, s.muv, s.sigmau, s.sigmav, s.pn)
            a, r, ok = compare(cosine_gq.cos_mode_sums_cuda(p.cheb, *sites),
                               cosine_gq.cos_mode_sums_torch(p.cheb, *sites), dtype)
            require(ok, f"K1 {preset}(L=5) in groups {str(dtype)[6:]} converged: max abs err "
                        f"{a:.3e}, rel {r:.3e}")
            if dtype == torch.float32:
                three = tuple(x[:3].contiguous() for x in sites)
                rec["K1_ms"] = {
                    "L=5": kernel_ms(lambda: cosine_gq.cos_mode_sums_cuda(p.cheb, *sites))[0],
                    "L=3": kernel_ms(lambda: cosine_gq.cos_mode_sums_cuda(p.cheb, *three))[0]}
                rec["K1_max_abs_err"] = a
        log(f"  {preset}(L=5) on {out['card']}: K1 converged f32 (median ms) {rec['K1_ms']}, "
            f"{groups} launches a call at L = 5")
        del probs
        torch.cuda.empty_cache()

    cfg = GQMAPConfig.full_mixture(K=65, quad_chunk=700, its=300)
    Mc, Nc = D7_CROP
    problem = pg.make_problem(cfg, I1[:Mc, :Nc], I2[:Mc, :Nc], fr, dev)
    st0 = pg.init_state(cfg, fr, D7_CROP, device=dev)
    zero()
    t = time.time()
    st, aux = pg.make_sweep(cfg, D7_CROP)(problem, st0)
    torch.cuda.synchronize()
    wall = time.time() - t
    counts = {k: f.launches for k, f in kfns.items()}
    by_path["full_mixture(K=65) crop (one sweep)"] = counts
    finite = all(bool(torch.isfinite(x).all()) for x in st if x.is_floating_point())
    require(finite and bool(torch.isfinite(aux.energy)) and counts == launch_counts(),
            f"full_mixture(K=65) {D7_CROP}: one sweep on 'auto' through the plain sums, finite, "
            f"no kernel launched ({counts})")
    refusals = {}
    for field in ("node_kernel", "edge_kernel"):
        try:
            pg.check_supported(dataclasses.replace(cfg, **{field: "cuda"}))
            refusals[field] = None
        except ValueError as e:
            refusals[field] = str(e)
        require(refusals[field] is not None
                and "does not take this configuration's shape" in refusals[field],
                f"full_mixture(K=65) {field}='cuda' refused with the limit named: "
                f"{refusals[field]}")
    out["full_mixture(K=65)"] = dict(crop=list(D7_CROP), sweep_s=wall, refusals=refusals)
    out["phase_s"] = time.time() - t_phase
    log(f"  full_mixture(K=65) {D7_CROP} on 'auto': one sweep {wall:.3f} s through the plain "
        f"sums; 'cuda' refused: {refusals}")
    log(f"  phase D7 {out['phase_s']:.1f} s")


def flow_sequence(seed, dev, H=H, W=W):
    """An H x W pair with a smooth, non-constant flow: smoothed noise as
    frame 1, frame 2 backward-warped from it by u = 1.5 + 1.5 cos(2 pi y / H),
    v = 0 (``tests/test_pipeline.py:46-67``; a constant GT gives a degenerate
    clamp box), and the GT with five unknown (1e10) pixels."""
    from gqmap_tpu_torch.ops.interp import fill_missing_nearest, interp2_linear

    r = np.random.default_rng(seed)
    I1 = smoothed_noise(r, H, W)
    yy, xx = np.mgrid[0:H, 0:W].astype(float)
    u = 1.5 + 1.5 * np.cos(2 * np.pi * yy / H)
    I2 = fill_missing_nearest(interp2_linear(torch.as_tensor(I1, device=dev), (xx + 1) - u,
                                             yy + 1)).cpu().numpy()
    gt = np.stack([u, np.zeros_like(u)], -1).astype(np.float32)
    gt[r.integers(2, H - 2, 5), r.integers(2, W - 2, 5)] = 1e10
    return I1, I2, gt


def drivers(dev, record, by_path, kfns, segment_ms):
    """Phases 19-23: the command line on a synthetic dataset, the
    coarse-to-fine pyramid, the lambda sweep and the suite loop, the
    structure-texture loop, and K3 at K = 11 on the L = 1 lattice. Every
    launch counter is set to 0 just before each driven run and read just
    after it."""
    import contextlib
    import io

    import scipy.io

    from gqmap_tpu_torch import GQMAPConfig, FlowRange, solve
    from gqmap_tpu_torch.cli import main as cli
    from gqmap_tpu_torch.io.dataset import load_sequence
    from gqmap_tpu_torch.io.flo import read_flo, write_flo
    from gqmap_tpu_torch.io.preprocess import structure_texture
    from gqmap_tpu_torch.kernels import build, edge_gq, edge_reduced_gq, node_gq
    from gqmap_tpu_torch.models import ctf as pctf
    from gqmap_tpu_torch.models import gqmap as pg
    from gqmap_tpu_torch.models.param_sweep import sweep_lambdas
    from gqmap_tpu_torch.ops.flowviz import flow_to_color
    from gqmap_tpu_torch.ops.gq import NODE, finalize

    def zero_counts():
        torch.cuda.synchronize()
        for f in kfns.values():
            f.launches = 0

    def counts():
        torch.cuda.synchronize()
        return {k: f.launches for k, f in kfns.items()}

    def run_cli(path, argv):
        """``python -m gqmap_tpu_torch.cli.main <argv>`` in this process, its
        standard output captured; the counters 0 just before, read after."""
        zero_counts()
        buf = io.StringIO()
        t = time.time()
        with contextlib.redirect_stdout(buf):
            cli.main(argv)
        wall = time.time() - t
        by_path[path] = c = counts()
        out = buf.getvalue()
        log(f"  $ python -m gqmap_tpu_torch.cli.main {' '.join(argv)}: {wall:.3f} s, "
            f"launches {c}")
        for line in out.strip().splitlines()[-4:]:
            log(f"    {line}")
        return out, c

    def last_json(out):
        return json.loads(out.strip().splitlines()[-1])

    # ---- 19. a synthetic dataset on disk; the command line's run
    log("phase drivers: dataset and command line")
    try:
        import imageio.v2 as imageio
    except ImportError:
        imageio = None
    png = imageio is not None
    log(f"  imageio imports: {png}" + ("" if png else "; the PNG frames and --out must raise "
                                                     "ImportError"))
    seqs = {"Venus": flow_sequence(0, dev, H, W), "Dimetrodon": flow_sequence(1, dev, H, W)}
    with tempfile.TemporaryDirectory(dir=build.BUILD_DIR) as root:
        os.environ["GQMAP_DATA"] = root
        os.makedirs(os.path.join(root, "preprocessed"))
        for name, (I1, I2, gt) in seqs.items():
            os.makedirs(os.path.join(root, name))
            write_flo(os.path.join(root, name, "flow10.flo"), gt)
            scipy.io.savemat(os.path.join(root, "preprocessed", f"{name}.mat"),
                             dict(img1=I1, img2=I2))
            if png:
                for fname, img in (("frame10.png", I1), ("frame11.png", I2)):
                    imageio.imwrite(os.path.join(root, name, fname),
                                    np.clip(np.round(img), 0, 255).astype(np.uint8))
        I1, I2, gt = seqs["Venus"]
        fc = flow_to_color(gt.astype(np.float64))
        fr = FlowRange(fc.minu, fc.maxu, fc.minv, fc.maxv)
        zero_aepe = float(np.mean(np.sqrt((fc.flo[1:-1, 1:-1] ** 2).sum(-1))))
        log(f"  dataset {root}: Venus and Dimetrodon, {H}x{W}, flow range {tuple(fr)}, the zero "
            f"flow's AEPE over the interior {zero_aepe:.4f}")
        seq = load_sequence("Venus", preprocessed=True)
        require(np.array_equal(seq.img1, I1) and np.array_equal(seq.gt_flow, gt),
                "load_sequence(preprocessed=True) reads back the frames and the GT as written")

        pre = ["--seq", "Venus", "--preprocessed"]
        fast = ["--preset", "tpu_fast", "--its", "600", "--eval-every", "300"]
        out, c = run_cli("cli run tpu_fast", ["run", *pre, *fast])
        got = last_json(out)
        n = got["iters"]
        require(n == 600 and c == launch_counts(K1=n, K2=n),
                f"run --preset tpu_fast: {n} sweeps (600 asked), launches {c}: K1 and K2 once a "
                "sweep, K3 and K4 0")
        direct = solve(GQMAPConfig.tpu_fast(its=600, eval_every=300), seq.img1, seq.img2,
                       gt_flow=seq.gt_flow, device=dev)
        require(got["best_aepe"] == direct.best_aepe,
                f"run's best AEPE {got['best_aepe']!r} equals a direct solve's "
                f"{direct.best_aepe!r}, bit for bit")
        require(direct.best_aepe < direct.AEPE[0],
                f"run: best AEPE {direct.best_aepe:.4f} below the AEPE at it=1 "
                f"{direct.AEPE[0]:.4f}")
        out, c = run_cli("cli run full_mixture",
                         ["run", *pre, "--its", "300", "--eval-every", "300"])
        n = last_json(out)["iters"]
        require(n == 300 and c == launch_counts(K3=n, K4=n),
                f"run (full_mixture): {n} sweeps (300 asked), launches {c}: K3 and K4 once a "
                "sweep, K1 and K2 0")
        try:
            with contextlib.redirect_stderr(io.StringIO()):
                cli.main(["run", *pre, "--devices", "2"])
            refusal = "no error"
        except RuntimeError as e:
            refusal = str(e)
        require("torch.distributed.run --nproc-per-node 2" in refusal,
                f"run --devices 2 in one process raises RuntimeError naming the command that "
                f"starts the ranks: {refusal}")

        out_dir = os.path.join(root, "out")
        out_argv = ["run", *pre, "--preset", "tpu_fast", "--its", "300", "--eval-every", "300",
                    "--quiet", "--out", out_dir]
        if png:
            out, c = run_cli("cli run --out", out_argv)
            npz = np.load(os.path.join(out_dir, "Venus.npz"))
            flo = read_flo(os.path.join(out_dir, "Venus.flo"))
            evals = [json.loads(x) for x in open(os.path.join(out_dir, "metrics.jsonl"))]
            pngs = sorted(f for f in os.listdir(out_dir) if f.endswith(".png"))
            shapes = {imageio.imread(os.path.join(out_dir, f)).shape for f in pngs}
            require(np.array_equal(flo, npz["map"].astype(np.float32))
                    and pngs == ["1.png", "300.png"] and shapes == {(H, W, 3)}
                    and [e["it"] for e in evals if e.get("event") == "eval"] == [1, 300],
                    f"run --out: .flo equal to the MAP in f32, PNGs {pngs} of {shapes}, "
                    f"metrics.jsonl {len(evals)} records, .npz {sorted(npz.files)}")
        else:
            try:
                run_cli("cli run --out", out_argv)
                outcome = "no error"
            except ImportError as e:
                outcome = f"ImportError: {e}"
            require(outcome.startswith("ImportError"), f"run --out without imageio: {outcome}")

        # ---- 20. the coarse-to-fine pyramid
        log("phase drivers: coarse-to-fine pyramid")
        ccfg = GQMAPConfig.ctf_level(its=300, eval_every=300)
        levels, real_solve = [], pctf.solve

        def timed_solve(*a, **k):  # each level's wall time
            torch.cuda.synchronize()
            t = time.time()
            res = real_solve(*a, **k)
            torch.cuda.synchronize()
            levels.append(dict(shape=list(res.map.shape[:2]), iters=res.iters,
                               wall_s=time.time() - t))
            return res

        pctf.solve = timed_solve
        zero_counts()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t = time.time()
        try:
            cres = pctf.solve_coarse_to_fine(ccfg, I1, I2, gt, device=dev, verbose=True)
        finally:
            pctf.solve = real_solve
        torch.cuda.synchronize()
        wall = time.time() - t
        peak = torch.cuda.max_memory_allocated() - base
        by_path["ctf"] = c = counts()
        sweeps = sum(lv.iters for lv in cres.levels)
        require(c == launch_counts(K3=sweeps, K4=sweeps),
                f"ctf: launches {c}: K3 and K4 equal to the levels' {sweeps} sweeps, K1 and K2 "
                "0")
        require(all(np.isfinite(lv.Energy[:lv.iters]).all() for lv in cres.levels)
                and bool(np.isfinite(cres.flow).all()),
                "ctf: every level's energy finite over every sweep, the flow finite")
        rises = [(float(lv.Energy[0]), float(lv.Energy[lv.iters - 1])) for lv in cres.levels]
        require(all(b > a for a, b in rises), f"ctf: each level's energy rises over its solve "
                                              f"(first, last sweep): {rises}")
        # not a check: the reference's pyramid compounds each level's error
        # (ROADMAP Queue 3, P5), so on this pair it ends above the zero flow
        log(f"  ctf final AEPE {cres.aepe:.4f}, the zero flow's {zero_aepe:.4f} (P5)")
        for lv in levels:
            lv["ms_a_sweep"] = lv["wall_s"] / lv["iters"] * 1e3
            log(f"  ctf level {lv['shape']}: {lv['iters']} sweeps in {lv['wall_s']:.3f} s "
                f"({lv['ms_a_sweep']:.4f} ms a sweep with make_problem and the readouts)")
        # the finest level's sweep alone: a 30-sweep segment and its split
        p32 = pg.make_problem(ccfg, I1, I2, fr, dev)
        st = cres.levels[-1].state
        seg = segment_ms("ctf_level finest level", ccfg, p32, st)
        a1 = torch.softmax(st.w, 0).reshape(1, 1, 1)

        def node_term(fn=node_gq.node_gq_cuda):
            """The node term as the sweep runs it: K4 (or ``fn``) and finalize."""
            raw = fn(p32.I1, p32.I2_tab, st.muu, st.muv, st.sigmau, st.sigmav, st.pn, ccfg.K,
                     ccfg.lambdad, ccfg.epsn)
            return finalize(raw, a1, st.sigmau, st.sigmav, st.pn, st.temperature, NODE)

        mu, sg = torch.stack([st.muu, st.muv]), torch.stack([st.sigmau, st.sigmav])
        k3_args = (mu, sg, *edge_reduced_gq.neighbour_stacks(mu, sg), st.rou, ccfg.K,
                   ccfg.lambdas, ccfg.epsn)
        sweep = pg.make_sweep(ccfg, (H, W))
        split = dict(sweep=time_ms(lambda: sweep(p32, st), 10), node=time_ms(node_term, 10),
                     K3=kernel_ms(lambda: edge_gq.edge_gq_cuda(*k3_args))[0])
        split["rest"] = split["sweep"] - split["node"] - split["K3"]
        split["node_plain"] = time_ms(lambda: node_term(functools.partial(
            node_gq.node_gq_torch, quad_chunk=ccfg.quad_chunk)), 5)
        record["ctf"] = dict(levels=levels, wall_s=wall, sweeps=sweeps, aepe=cres.aepe,
                             zero_flow_aepe=zero_aepe, GiB_above_held=peak / 2**30,
                             finest_segment_ms_per_sweep=seg, finest_sweep_split_ms=split,
                             card=smi("name,power.limit"))
        log(f"  ctf on {record['ctf']['card']}: {sweeps} sweeps over {len(levels)} levels in "
            f"{wall:.3f} s, AEPE {cres.aepe:.4f}, {peak / 2**30:.3f} GiB at peak above what the "
            "script held; finest sweep " + ", ".join(f"{k} {v:.4f} ms" for k, v in split.items()))
        del p32
        if png:
            out, c = run_cli("cli ctf", ["ctf", "--seq", "Venus", "--preset", "ctf_level", "--its",
                                         "300", "--eval-every", "300", "--quiet"])
            got = last_json(out)
            require(c["K1"] == c["K2"] == c["K5"] == 0 and 0 < c["K3"] == c["K4"] <= 4 * 300
                    and np.isfinite(got["aepe"]),
                    f"ctf subcommand on the PNG frames: AEPE {got['aepe']:.4f} (the zero flow's "
                    f"{zero_aepe:.4f}), launches {c}")

        # ---- 21. the lambda sweep and the suite loop
        log("phase drivers: lambda sweep and suite")
        scfg = GQMAPConfig.tpu_fast(its=300, eval_every=300)
        grid = np.linspace(0.300001, 1.0, 3)
        zero_counts()
        sw = sweep_lambdas(scfg, I1, I2, gt, lambdas=grid, device=dev)
        by_path["sweep_lambdas"] = c = counts()
        log("  " + sw.summary().replace("\n", "; "))
        require(sw.best_lambda in grid and c["K3"] == c["K4"] == c["K5"] == 0
                and c["K1"] == c["K2"] > 0,
                f"sweep_lambdas: best lambda {sw.best_lambda} of the grid, launches {c}")
        for lam, best in zip(grid, sw.best_aepe):
            want = solve(dataclasses.replace(scfg, lambdas=float(lam)), I1, I2, gt_flow=gt,
                         device=dev).best_aepe
            require(best == want, f"sweep_lambdas lambda_s={lam:.6g}: best AEPE {best!r} equals a "
                                  f"direct solve's {want!r}")
        for name in seqs:
            s = load_sequence(name, preprocessed=True)
            zero_counts()
            res = solve(scfg, s.img1, s.img2, gt_flow=s.gt_flow, device=dev)
            c = counts()
            require(c == launch_counts(K1=res.iters, K2=res.iters)
                    and res.best_aepe < res.AEPE[0],
                    f"suite {name}: best AEPE {res.best_aepe:.4f} below it=1's {res.AEPE[0]:.4f}, "
                    f"launches {c}")
        if png:
            flags = ["--preset", "tpu_fast", "--its", "300", "--eval-every", "300", "--quiet"]
            out, c = run_cli("cli suite", ["suite", "--seqs", "Venus,Dimetrodon", *flags])
            per_seq = last_json(out)["per_seq"]
            for name in seqs:
                s = load_sequence(name)
                want = solve(scfg, s.img1, s.img2, gt_flow=s.gt_flow, device=dev).best_aepe
                require(per_seq[name] == want, f"suite subcommand {name}: {per_seq[name]!r} equals "
                                               f"a direct solve's {want!r}")
            out, c = run_cli("cli sweep", ["sweep", "--seq", "Venus", *flags, "--range",
                                           "0.300001", "1.0", "3"])
            s = load_sequence("Venus")
            want = sweep_lambdas(scfg, s.img1, s.img2, s.gt_flow, lambdas=grid, device=dev)
            require(out == want.summary() + "\n", "sweep subcommand prints sweep_lambdas' summary")
        os.environ.pop("GQMAP_DATA")

    # ---- 22. structure-texture preprocessing on the card, float64
    log("phase drivers: structure_texture")
    structure_texture(I1[:32, :32], device=dev)  # first use
    torch.cuda.synchronize()
    t = time.time()
    on_card = structure_texture(I1, device=dev)
    t_card = time.time() - t
    t = time.time()
    on_cpu = structure_texture(I1, device="cpu")
    t_cpu = time.time() - t
    err = float(np.abs(on_card - on_cpu).max()) / float(I1.max() - I1.min())
    record["structure_texture"] = dict(card_s=t_card, cpu_s=t_cpu, rel_err=err)
    require(err <= 1e-10, f"structure_texture {H}x{W} f64 on the card: {t_card:.4f} s (the CPU "
                          f"{t_cpu:.4f} s), max error {err:.3e} of the image's range <= 1e-10")

    # ---- 23. K3 at K = 11 on the pyramid's L = 1 lattice
    log("phase drivers: K3 at K = 11 on the L = 1 lattice")
    c64 = dataclasses.replace(ccfg, dtype="float64")
    K = ccfg.K
    require(K in edge_gq.SPECIALISED and ccfg.L == 1, f"ctf_level: K = {K} (specialised), L = 1")
    for M, N in ((H, W), (-(-H // 8), -(-W // 8))):  # the finest and the coarsest level
        st0 = pg.init_state(c64, fr, (M, N), seed=0, device=dev)
        rec = k3_on_l1("ctf", ccfg, l1_probes(st0, torch.Generator().manual_seed(11)))
        record["K3"]["legacy"][f"K={K} ctf {M}x{N}"] = dict(rec, launches_ctf=by_path["ctf"]["K3"])

SHARDED_MESH = (1, 2, 2)  # (dp, x, y): 4 ranks of 188 x 226 sites at 376 x 452
SHARDED_SOLVE_ITS = 300
CHEB = dict(data_term="chebyshev", cheb_p=96, cheb_q=16)  # sweep_roofline's degrees


# the sharded phase's sweeps, each (2, 2)-sharded and single-process:
# make_cfg(dtype=...)
SHARDED_PATHS = {
    "tpu_fast": GQMAPConfig.tpu_fast,
    "full_mixture": functools.partial(GQMAPConfig.full_mixture, quad_chunk=27),
    "tpu_fast redblack": functools.partial(GQMAPConfig.tpu_fast, sweep_order="redblack"),
    "full_mixture chebyshev": functools.partial(GQMAPConfig.full_mixture, quad_chunk=27, **CHEB),
    "legacy_v3": GQMAPConfig.legacy_v3,
}
# the paths whose sharded sweep is the single-process sweep bit for bit: node
# and edge sums per site (K4, K5 or K7, and K3), no sum over the shards
# feeding the state
SHARDED_SAME_BITS = ("full_mixture", "full_mixture chebyshev", "legacy_v3")


def rank_main(rank, world, port, out_dir):
    """One rank of the sharded phase (``--rank``): every rank on ``cuda:0``.
    With ``world`` 1 the rank runs over NCCL and checks that its sharded
    ``tpu_fast`` sweep equals ``make_sweep``'s bit for bit; with 4 (gloo: the
    ranks share the card) it runs one sweep of each of :data:`SHARDED_PATHS`
    on its 188 x 226 block (rank 0 writes the gathered states), K2's padded call against its padded plain version,
    and a 300-sweep ``solve(mesh=...)``, each with the launch counters set to
    0 just before it and read just after. Writes ``rank<r>.json``."""
    import torch.distributed as tdist

    from gqmap_tpu_torch import FlowRange, GQMAPConfig, solve
    from gqmap_tpu_torch.kernels import (autodiff_gq, cheb_gq, cosine_gq, edge_gq,
                                         edge_reduced_gq, nearest_gq, node_gq, quad_gq,
                                         window_gq)
    from gqmap_tpu_torch.models import gqmap as pg
    from gqmap_tpu_torch.ops.gq import EDGE
    from gqmap_tpu_torch.parallel import (Mesh, gather_state, initialize, make_sharded_sweep,
                                          shard_problem, shard_state)
    from gqmap_tpu_torch.parallel.halo import halo_edges

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke rank: no CUDA device")
    n = initialize(f"localhost:{port}", world, rank)
    dev = torch.device("cuda", torch.cuda.current_device())
    kfns = {"K1": cosine_gq.cos_mode_sums_cuda, "K2": edge_reduced_gq.edge_reduced_grads_cuda,
            "K3": edge_gq.edge_gq_cuda, "K4": node_gq.node_gq_cuda,
            "K5": cheb_gq.cheb_gq_cuda, "K6": nearest_gq.nearest_gq_cuda,
            "K7": nearest_gq.nearest_chain_gq_cuda, "K10": quad_gq.quad_node_gq_cuda,
            "K11": quad_gq.truncquad_edge_gq_cuda, "K12": window_gq.node_window_gq_cuda,
            "K13": autodiff_gq.node_chain_gq_cuda, "K14": autodiff_gq.edge_chain_gq_cuda,
            "K15": autodiff_gq.edge_diff_adjoint_cuda,
            "K16": autodiff_gq.node_window_chain_gq_cuda}
    rec = dict(rank=rank, world=n, backend=tdist.get_backend(), checks=[], launches={})

    def check(ok, what):
        rec["checks"].append([bool(ok), what])

    def counted(path, fn):
        torch.cuda.synchronize()
        for f in kfns.values():
            f.launches = 0
        t = time.time()
        out = fn()
        torch.cuda.synchronize()
        rec.setdefault("wall_s", {})[path] = time.time() - t
        rec["launches"][path] = {k: f.launches for k, f in kfns.items()}
        return out

    I1, I2, gt = synthetic_pair()
    fr = FlowRange(*FR)
    if world == 1:
        mesh = Mesh(1, 1, 1, rank=0)
        cfg = GQMAPConfig.tpu_fast()
        prob = pg.make_problem(cfg, I1, I2, fr, dev)
        st = pg.init_state(cfg, fr, (H, W), seed=0, device=dev)
        # a mesh runs the plain glue (models/gqmap._update_route), the single
        # process K8 and K9: the sharded sweep is held bit for bit to the
        # single-process plain glue, state and sums, and its state to the
        # K8 route's bit for bit, whose sums differ in their order
        kern, kaux = pg.make_sweep(cfg, (H, W))(prob, st)
        kept = pg._update_route
        pg._update_route = lambda c, d, device: "plain"
        try:
            want, waux = pg.make_sweep(cfg, (H, W))(prob, st)
        finally:
            pg._update_route = kept
        got, gaux = counted("tpu_fast sharded (1 rank, NCCL)", lambda: make_sharded_sweep(
            cfg, (H, W), mesh)(shard_problem(prob, mesh), shard_state(st, mesh)))
        same = all(torch.equal(getattr(got, f), getattr(want, f)) for f in got._fields)
        same &= all(torch.equal(a, b) for a, b in zip(gaux, waux))
        check(same, "NCCL rank: the sharded tpu_fast sweep equals make_sweep's on the plain "
                    "glue, bit for bit")
        rel = max(abs(float(a) - float(b)) / abs(float(b)) for a, b in zip(kaux, gaux))
        check(all(torch.equal(getattr(got, f), getattr(kern, f)) for f in got._fields)
              and rel <= 1e-5, f"NCCL rank: the sharded tpu_fast sweep's state equals "
                               f"make_sweep's through K8 and K9, bit for bit; SweepAux within "
                               f"{rel:.3e} (summation order)")
    else:
        mesh = Mesh(*SHARDED_MESH, rank=rank)
        for path, make_cfg in SHARDED_PATHS.items():
            for dtype in ("float64", "float32") if path != "tpu_fast redblack" else ("float32",):
                cfg = make_cfg(dtype=dtype)
                whole = pg.make_problem(cfg, I1, I2, fr, dev)
                prob = shard_problem(whole, mesh)
                del whole
                # the f64 init, cast: the state the single-process sweeps start from
                st0 = pg.init_state(make_cfg(dtype="float64"), fr, (H, W), seed=0, device=dev)
                st = shard_state(pg.GQState(*(x.to(getattr(torch, dtype))
                                              if x.is_floating_point() else x for x in st0)),
                                 mesh)
                sweep = make_sharded_sweep(cfg, (H, W), mesh)
                out, aux = counted(f"{path} sharded sweep {dtype}", lambda: sweep(prob, st))
                out = gather_state(out, mesh)
                if rank == 0:
                    torch.save(dict({f: getattr(out, f).cpu() for f in out._fields},
                                    energy=aux.energy.cpu(), ptdmu=aux.ptdmu.cpu()),
                               os.path.join(out_dir, f"{path} {dtype}.pt"))
                if path == "tpu_fast":  # K2 on the block with its halo, padded both ways
                    mu = torch.stack([st.muu, st.muv])
                    sg = torch.stack([st.sigmau, st.sigmav])
                    halo = halo_edges(torch.stack([mu, sg]), mesh.ring("x"), mesh.ring("y"))
                    args = (mu, sg, st.rou, torch.softmax(st.w, 0), st.temperature,
                            2 * cfg.K + 3, cfg.lambdas, cfg.epsn, EDGE)
                    a, r, ok = compare(  # the six gradients: K2's E is None
                        edge_reduced_gq.edge_reduced_grads_cuda(*args, halo=halo)[:6],
                        edge_reduced_gq.edge_reduced_grads_torch(*args, halo=halo)[:6],
                        getattr(torch, dtype))
                    check(ok, f"rank {rank}: K2 with its halo on the padded block "
                              f"{tuple(mu.shape[:2])} + ({mu.shape[2] + 1}, {mu.shape[3] + 1}) "
                              f"{dtype} against its padded plain version: max abs err {a:.3e},"
                              f" rel {r:.3e}")
                del prob, st, sweep, out
                torch.cuda.empty_cache()
        cfg = GQMAPConfig.tpu_fast(its=SHARDED_SOLVE_ITS, eval_every=300)
        res = counted("tpu_fast sharded solve", lambda: solve(
            cfg, I1, I2, gt_flow=gt, flow_range=fr, seed=0, mesh=mesh, device=dev))
        rec["solve"] = dict(iters=res.iters, AEPE=[float(x) for x in res.AEPE],
                            Energy=[float(x) for x in res.Energy],
                            map_sum=float(np.sum(res.map, dtype=np.float64)),
                            mu_sum=float(np.sum(res.mu, dtype=np.float64)))
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(rec, f)
    tdist.barrier()
    tdist.destroy_process_group()


def sharded(dev, record, by_path, single_aepe):
    """The sharded phase: 4 ranks on ``cuda:0`` over gloo (the backend rule:
    they share the card) and 1 over NCCL (:func:`rank_main`), and the command
    line under ``torch.distributed.run`` with 2 ranks, all started together;
    meanwhile this process runs the single-process sweeps they are held to.
    A failed rank fails the run."""
    import socket

    from gqmap_tpu_torch import FlowRange
    from gqmap_tpu_torch.io.flo import write_flo
    from gqmap_tpu_torch.kernels import build
    from gqmap_tpu_torch.models import gqmap as pg

    import scipy.io

    def free_port():
        with socket.socket() as sk:
            sk.bind(("127.0.0.1", 0))
            return sk.getsockname()[1]

    log("phase sharded")
    t_phase = time.time()
    I1, I2, gt = synthetic_pair()
    fr = FlowRange(*FR)
    with tempfile.TemporaryDirectory(dir=build.BUILD_DIR) as d:
        nccl_dir, data = os.path.join(d, "nccl"), os.path.join(d, "data")
        os.makedirs(nccl_dir)
        os.makedirs(os.path.join(data, "preprocessed"))
        os.makedirs(os.path.join(data, "Venus"))
        vI1, vI2, vgt = flow_sequence(0, dev, H, W)
        write_flo(os.path.join(data, "Venus", "flow10.flo"), vgt)
        scipy.io.savemat(os.path.join(data, "preprocessed", "Venus.mat"), dict(img1=vI1, img2=vI2))
        me = os.path.abspath(__file__)
        port, nport = free_port(), free_port()
        env = dict(os.environ, GQMAP_DATA=data, OMP_NUM_THREADS="1")
        cli_argv = ["run", "--seq", "Venus", "--preprocessed", "--preset", "tpu_fast", "--its",
                    "30", "--eval-every", "30", "--quiet", "--devices", "2"]
        cmds = {f"rank {r}": [sys.executable, me, "--rank", str(r), "--world", "4", "--port",
                              str(port), "--dir", d] for r in range(4)}
        cmds["nccl rank"] = [sys.executable, me, "--rank", "0", "--world", "1", "--port",
                             str(nport), "--dir", nccl_dir]
        cmds["cli"] = [sys.executable, "-m", "torch.distributed.run", "--standalone",
                       "--nproc-per-node", "2", "-m", "gqmap_tpu_torch.cli.main", *cli_argv]
        procs = {k: subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                     text=True, env=env,
                                     cwd=os.path.dirname(me)) for k, c in cmds.items()}
        try:
            # the single-process sweeps on the card, while the ranks start
            gold = {}
            for path, make_cfg in SHARDED_PATHS.items():
                for dtype in ("float64", "float32"):
                    cfg = make_cfg(dtype=dtype)
                    prob = pg.make_problem(cfg, I1, I2, fr, dev)
                    # the f64 init, cast, as each rank makes it
                    st0 = pg.init_state(make_cfg(dtype="float64"), fr, (H, W), seed=0, device=dev)
                    st = pg.GQState(*(x.to(getattr(torch, dtype)) if x.is_floating_point()
                                      else x for x in st0))
                    out, aux = pg.make_sweep(cfg, (H, W))(prob, st)
                    gold[path, dtype] = (out, aux)
                    del prob
                    torch.cuda.empty_cache()
            outs = {}
            for k, p in procs.items():
                outs[k] = p.communicate(timeout=max(60.0, 900 - (time.time() - t_phase)))[0]
        except BaseException:
            for p in procs.values():
                p.kill()  # the exact processes started here
            for p in procs.values():
                p.wait()
            raise
        for k, p in procs.items():
            ok = p.returncode == 0
            require(ok, f"sharded: {k} exits 0 (exit code {p.returncode})")
            if not ok:
                log(outs[k][-4000:])
        log("  ranks' lines: " + " | ".join(
            line for k in ("rank 0", "nccl rank") for line in outs[k].splitlines()
            if line.startswith("gqmap_tpu_torch.parallel")))
        recs = {}
        for name, path in [(f"rank {r}", os.path.join(d, f"rank{r}.json")) for r in range(4)] + [
                ("nccl rank", os.path.join(nccl_dir, "rank0.json"))]:
            if os.path.exists(path):
                with open(path) as f:
                    recs[name] = json.load(f)
        require(len(recs) == 5, f"sharded: every rank wrote its record ({sorted(recs)})")
        for name, rec in recs.items():
            for ok, what in rec["checks"]:
                require(ok, what)
        if "nccl rank" in recs:
            require(recs["nccl rank"]["backend"] == "nccl"
                    and all(recs[f"rank {r}"]["backend"] == "gloo" for r in range(4)
                            if f"rank {r}" in recs),
                    "backends: NCCL for the rank with a card of its own, gloo for 4 ranks on "
                    "one card")
        # the (2, 2) sweeps against the single-process sweeps on the card
        fields = ("muu", "muv", "sigmau", "sigmav", "pn", "rou", "w")
        for path in SHARDED_PATHS:
            g64 = gold[path, "float64"][0]
            for dtype in ("float64", "float32"):
                f = os.path.join(d, f"{path} {dtype}.pt")
                if not os.path.exists(f):
                    continue
                sh = torch.load(f)
                if path in SHARDED_SAME_BITS:  # K4, K5 or K7, K3: per site, the whole's
                    g = gold[path, dtype][0]
                    same = all(torch.equal(sh[k].to(dev), getattr(g, k)) for k in fields[:6])
                    require(same, f"sharded {path} (2, 2) {dtype} sweep: the state fields equal "
                                  "the single-process sweep's, bit for bit")
                if dtype == "float64":
                    rel = max(float((sh[k].to(dev) - getattr(g64, k)).abs().max()
                                    / getattr(g64, k).abs().max().clamp_min(1e-300))
                              for k in fields)
                    require(rel <= 1e-12, f"sharded {path} (2, 2) f64 sweep: every field "
                                          f"within 1e-12 relative of the single-process "
                                          f"sweep's ({rel:.3e})")
                    continue
                s32 = gold[path, "float32"][0]
                e_sh = max(float((sh[k].to(dev).double() - getattr(g64, k)).abs().mean())
                           for k in fields[:6])
                e_1 = max(float((getattr(s32, k).double() - getattr(g64, k)).abs().mean())
                          for k in fields[:6])
                big = max(float((sh[k].to(dev) - getattr(s32, k)).abs().max()) for k in fields)
                require(e_sh <= 2.0 * e_1 + 1e-12,
                        f"sharded {path} (2, 2) f32 sweep: error vs the f64 golden {e_sh:.3e} "
                        f"<= 2 x the single-process f32 sweep's {e_1:.3e}; largest difference "
                        f"from the single-process f32 sweep {big:.3e}")
        per_rank = [recs.get(f"rank {r}", {}).get("launches", {}) for r in range(4)]
        fast, exact, cheb, chain = (launch_counts(K1=1, K2=1), launch_counts(K3=1, K4=1),
                                    launch_counts(K3=1, K5=1), launch_counts(K3=1, K7=1))
        want = {"tpu_fast sharded sweep float64": fast, "tpu_fast sharded sweep float32": fast,
                "full_mixture sharded sweep float64": exact,
                "full_mixture sharded sweep float32": exact,
                "tpu_fast redblack sharded sweep float32": {k: 2 * v for k, v in fast.items()},
                "full_mixture chebyshev sharded sweep float64": cheb,
                "full_mixture chebyshev sharded sweep float32": cheb,
                "legacy_v3 sharded sweep float64": chain, "legacy_v3 sharded sweep float32": chain,
                "tpu_fast sharded solve": {k: SHARDED_SOLVE_ITS * v for k, v in fast.items()}}
        for path, w in want.items():
            got = [c.get(path) for c in per_rank]
            require(all(g == w for g in got), f"sharded {path}: each rank's launch counters "
                                              f"{got} equal {w}")
            by_path[f"{path} (2, 2), each of 4 ranks"] = got[0]
        if "nccl rank" in recs:
            by_path["tpu_fast sharded sweep (1 rank, NCCL)"] = recs["nccl rank"]["launches"].get(
                "tpu_fast sharded (1 rank, NCCL)")
        sol = [recs[f"rank {r}"]["solve"] for r in range(4) if f"rank {r}" in recs]
        if sol:
            a = np.array(sol[0]["AEPE"])
            a1, an = a[0], a[sol[0]["iters"] - 1]
            require(all(s == sol[0] for s in sol), "sharded solve: the same result (AEPE and "
                                                   "energy traces, MAP, means) on every rank")
            require(bool(an < a1), f"sharded solve: AEPE {a1:.4f} at it=1 -> {an:.4f} at "
                                   f"it={sol[0]['iters']} (falls)")
            require(abs(an - single_aepe) <= 0.1 * single_aepe,
                    f"sharded solve: final AEPE {an:.4f} within 10% of the single-process "
                    f"solve's {single_aepe:.4f} at it={SHARDED_SOLVE_ITS}")
            walls = [recs[f"rank {r}"]["wall_s"]["tpu_fast sharded solve"] for r in range(4)
                     if f"rank {r}" in recs]
            record["sharded"] = dict(
                mesh=list(SHARDED_MESH), solve_wall_s=walls, solve_aepe=[a1, an],
                single_aepe=single_aepe,
                solve_ms_per_sweep_4_ranks_sharing_one_card=max(walls) / SHARDED_SOLVE_ITS * 1e3,
                sweep_wall_s=recs["rank 0"]["wall_s"])
            log(f"  sharded solve, 4 ranks time-sliced on one card (not a multi-GPU speed): "
                f"wall {max(walls):.3f} s for {SHARDED_SOLVE_ITS} sweeps incl. set-up and 2 "
                f"readouts; AEPE {a1:.4f} -> {an:.4f} (single process {single_aepe:.4f}); "
                f"each rank's sweep walls {recs['rank 0']['wall_s']}")
        lines = [x for x in outs["cli"].splitlines() if x.startswith("{")]
        require(len(lines) == 1 and json.loads(lines[0]).get("iters") == 30,
                f"run --devices 2 under torch.distributed.run prints one JSON line, from rank 0: "
                f"{lines}")
    record.setdefault("phase_s", {})["sharded"] = time.time() - t_phase
    log(f"  phase sharded {time.time() - t_phase:.1f} s")


D4_RUNS = 5


def chebyshev(dev, record, by_path, kfns, st64, cast):
    """Phases 25-26: the Chebyshev data term. One 376x452 sweep of
    ``full_mixture(quad_chunk=27, data_term="chebyshev", cheb_p=96,
    cheb_q=16)`` (through K5 and K3) and of ``tpu_fast(data_term="chebyshev")``
    (through K5 and K2) three ways, from the init and the sigma = 0.05
    states, with each kernel arm's launches, ms a sweep, node term (K5 and
    its plain version) and peak memory; then a ``full_mixture`` Chebyshev
    solve (300 sweeps, a readout every 100; 100 and 50 where a sweep takes
    more than 0.1 s) with its launch counters set to 0 just before it: finite
    energy, the AEPE at the end below that at it = 1, K3 and K5 once a sweep
    and K1, K2 and K4 not at all, and its peak memory."""
    from gqmap_tpu_torch import FlowRange, GQMAPConfig, solve
    from gqmap_tpu_torch.kernels import cheb_gq
    from gqmap_tpu_torch.models import gqmap as pg

    def counts():
        torch.cuda.synchronize()
        return {k: f.launches for k, f in kfns.items()}

    I1, I2, gt = synthetic_pair()
    fr = FlowRange(*FR)
    conv64 = st64._replace(sigmau=torch.full_like(st64.sigmau, 0.05),
                           sigmav=torch.full_like(st64.sigmav, 0.05))
    states = (("init", st64), ("converged", conv64))
    rec = record["chebyshev"] = dict(card=smi("name,power.limit"))
    log("phase chebyshev sweeps")
    for label, c32, kernel in (
            ("full_mixture chebyshev", GQMAPConfig.full_mixture(quad_chunk=27, **CHEB), "K3"),
            ("tpu_fast chebyshev", GQMAPConfig.tpu_fast(data_term="chebyshev"), "K2")):
        c64 = dataclasses.replace(c32, dtype="float64")
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t = time.time()
        p32 = pg.make_problem(c32, I1, I2, fr, dev)
        torch.cuda.synchronize()
        t_build = time.time() - t
        build_peak = torch.cuda.max_memory_allocated() - base
        probs = {torch.float32: p32, torch.float64: pg.make_problem(c64, I1, I2, fr, dev)}
        plain = dict(node_kernel="torch", edge_kernel="torch")
        kern = pg.make_sweep(dataclasses.replace(c32, node_kernel="cuda", edge_kernel="cuda"),
                             (H, W))
        for f in kfns.values():
            f.launches = 0
        three_way_sweep(label + " ", pg.make_sweep(dataclasses.replace(c64, **plain), (H, W)),
                        pg.make_sweep(dataclasses.replace(c32, **plain), (H, W)),
                        kern, probs, states, cast)
        by_path[f"{label} sweep (kernel arm, 2 states)"] = c = counts()
        want = {k: (len(states) if k in (kernel, "K5") else 0) for k in kfns}
        require(c == want, f"{label}: the kernel arm's launches {c} equal {want}")
        del probs[torch.float64]
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        st = cast(conv64, torch.float32)
        ms = time_ms(lambda: kern(p32, st), 3)
        sweep_peak = torch.cuda.max_memory_allocated() - base
        s5 = (st.muu, st.muv, st.sigmau, st.sigmav, st.pn)
        node = kernel_ms(lambda: cheb_gq.cheb_gq_cuda(p32.cheb, *s5, c32.K))[0]
        node_plain = time_ms(lambda: cheb_gq.cheb_gq_torch(p32.cheb, *s5, c32.K,
                                                           quad_chunk=c32.quad_chunk), 3)
        rec[label] = dict(ms_a_sweep=ms, node_term_K5_ms=node, node_term_plain_ms=node_plain,
                          make_problem_s=t_build, make_problem_GiB_above_held=build_peak / 2**30,
                          sweep_GiB_above_held=sweep_peak / 2**30,
                          coefficients=list(p32.cheb.coeffs.shape))
        log(f"  {label} on {rec['card']}: {ms:.4f} ms a sweep from sigma = 0.05 (CUDA events, "
            f"mean of 3), the node term: K5 {node:.4f} ms, plain {node_plain:.4f} ms; "
            f"{sweep_peak / 2**30:.3f} GiB above held at peak; make_problem {t_build:.3f} s, "
            f"{build_peak / 2**30:.3f} GiB above held, coefficients "
            f"{tuple(p32.cheb.coeffs.shape)}")
        del probs, p32, kern

    log("phase chebyshev solve")
    ms = rec["full_mixture chebyshev"]["ms_a_sweep"]
    its, every = (300, 100) if ms <= 100.0 else (100, 50)
    if its == 100:
        log(f"  a sweep takes {ms:.1f} ms > 0.1 s: the solve runs its=100, eval_every=50")
    cfg = GQMAPConfig.full_mixture(quad_chunk=27, its=its, eval_every=every, **CHEB)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    for f in kfns.values():
        f.launches = 0
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t = time.time()
    res = solve(cfg, I1, I2, gt_flow=gt, flow_range=fr, device=dev, verbose=True)
    torch.cuda.synchronize()
    wall = time.time() - t
    peak = torch.cuda.max_memory_allocated() - base
    by_path["full_mixture chebyshev solve"] = c = counts()
    n = res.iters
    a1, an = res.AEPE[0], res.AEPE[n - 1]
    require(n == its and bool(np.isfinite(res.Energy[:n]).all()),
            f"chebyshev solve: {n} sweeps ({its} asked), energy finite over every sweep")
    require(bool(an < a1), f"chebyshev solve: AEPE {a1:.4f} at it=1 -> {an:.4f} at it={n} "
                           "(falls)")
    require(c == launch_counts(K3=n, K5=n),
            f"chebyshev solve: launches {c}: K3 and K5 equal to the sweep count {n}, K1, K2 and "
            "K4 0")
    rec["solve"] = dict(its=its, eval_every=every, wall_s=wall, GiB_above_held=peak / 2**30,
                        aepe=[float(x) for x in res.AEPE if np.isfinite(x)])
    log(f"  chebyshev solve: {n} sweeps in {wall:.3f} s with make_problem and readouts, "
        f"{peak / 2**30:.3f} GiB at peak above what the script held; AEPE "
        f"{rec['solve']['aepe']}")


def roofline_phase(dev, record, by_path, kfns, ceil):
    """Phase 27: ``flagship_roofline`` and ``sweep_roofline`` over all four
    modes at 376x452 on the measured ceilings; each bound must be below the
    time it bounds."""
    log("phase roofline")
    torch.cuda.synchronize()
    for f in kfns.values():
        f.launches = 0
    t = time.time()
    fl = roofline.flagship_roofline((H, W), ceilings=ceil, device=dev)
    sw = roofline.sweep_roofline((H, W), ceilings=ceil, device=dev)
    torch.cuda.synchronize()
    by_path["roofline (flagship and mode sweeps)"] = {k: f.launches for k, f in kfns.items()}
    record["roofline"] = dict(flagship={k: fl[k] for k in ("cosine_kernel_v1", "tpu_fast_sweep")},
                              modes=sw["modes"], card=ceil["card"], seconds=time.time() - t)
    k, sp = fl["cosine_kernel_v1"], fl["tpu_fast_sweep"]
    log(f"  K1 v1 alone {k['ms']:.4f} ms, bounds {k['bound_ms']} ms, governing {k['governing']}"
        f", share {k['share_of_bound']:.3f}; tpu_fast segment {sp['ms']:.4f} ms a sweep "
        f"({sp['mpix_sweeps_per_s']:.3f} Mpixel-sweeps/s), bound {sp['bound_ms']:.4f} ms, share "
        f"{sp['share_of_bound']:.3f}")
    shares = {"K1 v1": k["share_of_bound"], "tpu_fast segment": sp["share_of_bound"]}
    for mode, m in sw["modes"].items():
        log(f"  mode {mode}: {m['ms_per_sweep']:.4f} ms a sweep, {m['mpix_sweeps_per_s']:.3f} "
            f"Mpixel-sweeps/s; bound {m['bound_ms']:.4f} ms by {m['governing_bound']}, share "
            f"{m['share_of_bound']:.3f}")
        shares[mode] = m["share_of_bound"]
    require(all(0.0 < v <= 1.0 for v in shares.values()),
            f"roofline: every bound below its time (shares {shares})")


def bench_phase(record):
    """Phase 28: ``python -m gqmap_tpu_torch.cli.main bench`` in three
    processes, one after the other: one JSON line each with bench.py's keys,
    finite positive rates and the card's line from ``nvidia-smi``."""
    log("phase bench")
    root = os.path.dirname(os.path.abspath(__file__))
    runs = []
    for i in range(3):
        t = time.time()
        p = subprocess.run([sys.executable, "-m", "gqmap_tpu_torch.cli.main", "bench"],
                           capture_output=True, text=True, timeout=600, cwd=root)
        lines = p.stdout.strip().splitlines()
        ok = p.returncode == 0 and len(lines) == 1
        require(ok, f"bench run {i}: exit code {p.returncode}, {len(lines)} line(s) on stdout")
        if not ok:
            log(p.stdout[-2000:] + p.stderr[-4000:])
            continue
        got = json.loads(lines[0])
        keys = {"metric", "value", "unit", "vs_baseline", "mode", "steady_state", "from_init",
                "device"}
        rates = (got.get("value"), got.get("from_init"))
        require(set(got) == keys and all(isinstance(v, float) and np.isfinite(v) and v > 0
                                         for v in rates)
                and got["device"] == smi("name,power.limit"),
                f"bench run {i} ({time.time() - t:.1f} s): {lines[0]}")
        runs.append(got)
    if runs:
        conv = [r["value"] for r in runs]
        init = [r["from_init"] for r in runs]
        spread = (max(conv) - min(conv)) / float(np.median(conv))
        record["bench"] = dict(converged=conv, from_init=init, converged_spread=spread,
                               device=runs[0]["device"])
        log(f"  bench converged {conv} Mpixel-sweeps/s (spread {100 * spread:.1f}% of the "
            f"median), from init {init}, on {runs[0]['device']}")


def d4_phase(dev, record):
    """Phase 29: D4, the command line's process group ended with the
    command: ``run --devices 2`` under ``torch.distributed.run`` with 2 ranks
    on the card, 5 runs started together, each exiting 0 with one JSON line."""
    import scipy.io

    from gqmap_tpu_torch.io.flo import write_flo
    from gqmap_tpu_torch.kernels import build

    log("phase D4")
    t = time.time()
    with tempfile.TemporaryDirectory(dir=build.BUILD_DIR) as d:
        os.makedirs(os.path.join(d, "preprocessed"))
        os.makedirs(os.path.join(d, "Venus"))
        I1, I2, gt = flow_sequence(0, dev, H, W)
        write_flo(os.path.join(d, "Venus", "flow10.flo"), gt)
        scipy.io.savemat(os.path.join(d, "preprocessed", "Venus.mat"), dict(img1=I1, img2=I2))
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
               "2", "-m", "gqmap_tpu_torch.cli.main", "run", "--seq", "Venus", "--preprocessed",
               "--preset", "tpu_fast", "--its", "30", "--eval-every", "30", "--quiet",
               "--devices", "2"]
        env = dict(os.environ, GQMAP_DATA=d, OMP_NUM_THREADS="1")
        procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                  text=True, env=env,
                                  cwd=os.path.dirname(os.path.abspath(__file__)))
                 for _ in range(D4_RUNS)]
        try:
            outs = [p.communicate(timeout=600)[0] for p in procs]
        except BaseException:
            for p in procs:
                p.kill()  # the exact processes started here
            for p in procs:
                p.wait()
            raise
    codes = [p.returncode for p in procs]
    lines = [sum(x.startswith("{") for x in out.splitlines()) for out in outs]
    for code, out in zip(codes, outs):
        if code:
            log(out[-3000:])
    require(codes == [0] * D4_RUNS and lines == [1] * D4_RUNS,
            f"D4: {D4_RUNS} two-rank CLI runs under torch.distributed.run: exit codes {codes}, "
            f"JSON lines {lines}")
    record["d4"] = dict(exit_codes=codes, wall_s=time.time() - t)
    log(f"  D4: {D4_RUNS} runs together in {time.time() - t:.1f} s")


def stop_point(trace, limit, poll):
    """``(skip, k)``: a segment from the state after ``skip`` sweeps whose
    |dmu| trace ``trace[skip:]`` first falls below all before it at sweep
    ``k + 1 <= limit``, not at the end of a window of ``poll`` sweeps; k = 6
    where the trace allows, else the least k >= 3. None if there is none."""
    for want in [6] + list(range(3, limit)):
        for skip in range(len(trace) - want):
            if (want + 1) % poll and trace[skip + want] < trace[skip:skip + want].min():
                return skip, want
    return None


GRAPH_SWEEPS = 300  # the graph phase's segments (100 converged on the two slow paths)
WINDOW_PLAIN_SWEEPS = 5  # the windowed term's plain-sums turn (~0.6 s a sweep)
GRAPH_POLLS = (1, 5, 10, 25, 100)  # POLL values timed on the converged tpu_fast(_super)


def graph_phase(dev, record, by_path, kfns):
    """Phase 30: the segment runner's graph route against its host loop at
    376x452 f32 on ``tpu_fast``, ``full_mixture``, red-black ``tpu_fast``,
    ``tpu_fast_super``, ``super_entropy``, ``ctf_level``, the Chebyshev
    ``full_mixture`` (K5 and K3) and the two windowed bicubic paths (K12 and
    K3): the route is ``"graph"``; from the init and from the sigma = 0.05
    state both runners end in the same state and traces, bit for bit, after
    300 sweeps (100 converged on the K4, K5 and K12 paths), with the same
    launch counts; on the K4 paths the graph's ms a sweep with K4 v1 beside
    v2's, on the Chebyshev path with K5 v1 beside v2's, in turns; on the
    K12 paths its other variant's and its default's again, in turns, bit for
    bit, then around the plain sums; each
    runner's ms a sweep by CUDA events, the capture's seconds and the peak
    device memory of the capturing call; an early stop that trips inside a
    poll window (``tor`` from the host loop's |dmu| trace) gives the host
    loop's ``n``, flag, traces and state; ms a sweep at each POLL of
    :data:`GRAPH_POLLS`; and 3 sweeps of every other single-process
    configuration, graph against host loop bit for bit. (Graph sweeps are
    profiled in the last phase.)"""
    from gqmap_tpu_torch import FlowRange, GQMAPConfig
    from gqmap_tpu_torch.models import gqmap as pg

    log("phase graph segments")
    t_phase = time.time()
    I1, I2, _ = synthetic_pair()
    fr = FlowRange(*FR)
    paths = {
        "tpu_fast": (GQMAPConfig.tpu_fast(), GRAPH_SWEEPS),
        "full_mixture": (GQMAPConfig.full_mixture(quad_chunk=27), 100),
        "tpu_fast redblack": (GQMAPConfig.tpu_fast(sweep_order="redblack"), GRAPH_SWEEPS),
        "tpu_fast_super": (GQMAPConfig.tpu_fast_super(), GRAPH_SWEEPS),
        "super_entropy": (GQMAPConfig.super_entropy(), 100),
        "ctf_level": (GQMAPConfig.ctf_level(), 100),
        "full_mixture chebyshev": (GQMAPConfig.full_mixture(quad_chunk=27, **CHEB), 100),
        "full_mixture window_rg=2": (GQMAPConfig.full_mixture(quad_chunk=27, window_rg=2), 100),
        "legacy_v2 bicubic": (GQMAPConfig.legacy_v2(data_term="bicubic", quad_chunk=27), 100),
    }
    out = record["graph"] = {"card": smi("name,power.limit"), "POLL": pg.POLL}

    def zero():
        torch.cuda.synchronize()
        for f in kfns.values():
            f.launches = 0

    def timed(seg, problem, state, n):
        """``seg(problem, state, n)``, its ms a sweep by CUDA events, and the
        launch counts of the call (0 just before it)."""
        zero()
        t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0.record()
        res = seg(problem, state, n)
        t1.record()
        torch.cuda.synchronize()
        return res, t0.elapsed_time(t1) / n, {k: f.launches for k, f in kfns.items()}

    def same(a, b):
        """Bit-for-bit equality of two segment results: state, n, traces, flag."""
        return (all(torch.equal(x, y) for x, y in zip(a[0], b[0])) and a[1] == b[1]
                and all(torch.equal(a[i], b[i]) for i in (2, 3, 4)) and a[5] == b[5])

    for path, (base, conv_n) in paths.items():
        cfg = dataclasses.replace(base, its=100000, eval_every=GRAPH_SWEEPS, tor=0.0)
        problem = pg.make_problem(cfg, I1, I2, fr, dev)
        init = pg.init_state(cfg, fr, (H, W), seed=0, device=dev)
        conv = init._replace(sigmau=torch.full_like(init.sigmau, 0.05),
                             sigmav=torch.full_like(init.sigmav, 0.05))
        host = pg.SegmentRunner(cfg, (H, W), _route="host")
        graph = pg.make_segment_runner(cfg, (H, W))
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        held, reserved = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
        torch.cuda.reset_peak_memory_stats()
        zero()
        graph(problem, init, 10)  # the capture
        torch.cuda.synchronize()
        rec = out[path] = dict(
            capture_s=graph.capture_s,
            capture_call_GiB_above_held=(torch.cuda.max_memory_allocated() - held) / 2**30,
            reserved_GiB_above=(torch.cuda.memory_reserved() - reserved) / 2**30,
            capture_call_launches={k: f.launches for k, f in kfns.items()})
        require(graph.route == "graph", f"graph {path}: route {graph.route!r} is 'graph'")
        ends = {}
        for sname, st, n in (("init", init, GRAPH_SWEEPS), ("converged", conv, conv_n)):
            h, h_ms, h_counts = timed(host, problem, st, n)
            g, g_ms, g_counts = ends[sname] = timed(graph, problem, st, n)
            rec[sname] = dict(sweeps=n, host_ms=h_ms, graph_ms=g_ms, host_launches=h_counts,
                              graph_launches=g_counts, graph_polls=graph.polls)
            by_path[f"graph {path} {sname} ({n} sweeps)"] = g_counts
            require(host.route == "host" and graph.route == "graph" and h[1] == g[1] == n,
                    f"graph {path} {sname}: both runners ran {n} sweeps ({h[1]}, {g[1]})")
            require(same(h, g), f"graph {path} {sname}: the graph's state and traces after {n} "
                                "sweeps equal the host loop's, bit for bit")
            require(g_counts == h_counts and sum(h_counts.values()) > 0,
                    f"graph {path} {sname}: launch counts {g_counts} equal the host loop's "
                    f"{h_counts}")
            require(graph.polls == -(-n // pg.POLL),
                    f"graph {path} {sname}: {graph.polls} reads of (n, stop) for {n} sweeps at "
                    f"POLL {pg.POLL}")
        log(f"  {path} on {out['card']}: ms a sweep host / graph, from init "
            f"{rec['init']['host_ms']:.4f} / {rec['init']['graph_ms']:.4f}, converged "
            f"{rec['converged']['host_ms']:.4f} / {rec['converged']['graph_ms']:.4f}; capture "
            f"{rec['capture_s']:.3f} s, the capturing call {rec['capture_call_GiB_above_held']:.3f}"
            f" GiB at peak above held, reserved +{rec['reserved_GiB_above']:.3f} GiB; launches "
            f"{rec['init']['graph_launches']}")
        if cfg.data_term == "bicubic" and cfg.window_rg > 0:
            # the windowed term in turns, converged: K12's default variant
            # (above), its other variant (a runner captured with it as the
            # default) and the default again, their states and traces bit for
            # bit (v2 is v1's arithmetic); then the plain sums around K8 v2 (a
            # runner captured with them in K12's place; WINDOW_PLAIN_SWEEPS
            # sweeps, at ~0.6 s a sweep)
            from gqmap_tpu_torch.kernels import window_gq

            c = rec["converged"]
            default = window_gq._DEFAULT_VARIANT
            other = next(v for v in window_gq.VARIANTS if v != default)
            window_gq._DEFAULT_VARIANT = other
            try:
                alt = pg.make_segment_runner(cfg, (H, W))
                alt(problem, init, 10)  # the capture
                g_alt, c[f"graph_ms_k12_{other}"], alt_counts = timed(alt, problem, conv, conv_n)
            finally:
                window_gq._DEFAULT_VARIANT = default
            del alt
            torch.cuda.empty_cache()
            g_again, c["graph_ms_again"], again_counts = timed(graph, problem, conv, conv_n)
            by_path[f"graph {path} converged K12 {other} ({conv_n} sweeps)"] = alt_counts
            require(same(ends["converged"][0], g_alt) and same(ends["converged"][0], g_again),
                    f"graph {path}: the {conv_n}-sweep segments through K12 {default}, "
                    f"{other} and {default} again end in the same state and traces, bit for "
                    "bit")
            require(alt_counts == again_counts == c["graph_launches"],
                    f"graph {path}: K12 {other}'s turn launches as {default}'s "
                    f"({alt_counts}, {again_counts})")
            kept = dict(pg._NODE_WINDOW)
            pg._NODE_WINDOW["auto"] = window_gq.node_window_gq_torch
            try:
                torch.cuda.synchronize()
                torch.cuda.empty_cache()
                held_p = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                old = pg.make_segment_runner(cfg, (H, W))
                old(problem, conv, 2)  # the capture
                torch.cuda.synchronize()
                rec["plain_sums_capture_call_GiB_above_held"] = (
                    torch.cuda.max_memory_allocated() - held_p) / 2**30
            finally:
                pg._NODE_WINDOW.update(kept)
            _, c["graph_ms_plain_sums"], plain_counts = timed(old, problem, conv,
                                                               WINDOW_PLAIN_SWEEPS)
            del old
            torch.cuda.empty_cache()
            require(plain_counts["K12"] == 0 and c["graph_launches"]["K12"] == conv_n
                    and c["graph_launches"]["K4"] == 0,
                    f"graph {path}: K12 once a sweep ({c['graph_launches']}), not at all around "
                    f"the plain sums ({plain_counts})")
            log(f"  {path} graph, converged ms a sweep with K12 {default} / {other} / "
                f"{default} again / the plain sums: {c['graph_ms']:.4f} / "
                f"{c[f'graph_ms_k12_{other}']:.4f} / {c['graph_ms_again']:.4f} / "
                f"{c['graph_ms_plain_sums']:.4f}; the capturing call's peak above held: K12 "
                f"{rec['capture_call_GiB_above_held']:.3f} GiB, plain sums "
                f"{rec['plain_sums_capture_call_GiB_above_held']:.3f} GiB")
        elif cfg.data_term in ("bicubic", "chebyshev"):
            # the node kernel's variants on the graph route, in turns: v2 (the
            # default, above), v1 (a runner captured with v1 as the default),
            # v2 again (K4 on the bicubic paths, K5 on the Chebyshev one)
            from gqmap_tpu_torch.kernels import cheb_gq, node_gq

            mod, kn = (node_gq, "k4") if cfg.data_term == "bicubic" else (cheb_gq, "k5")
            default, mod._DEFAULT_VARIANT = mod._DEFAULT_VARIANT, "v1"
            try:
                old = pg.make_segment_runner(cfg, (H, W))
                old(problem, init, 10)
                for sname, st, n in (("init", init, GRAPH_SWEEPS), ("converged", conv, conv_n)):
                    rec[sname][f"graph_ms_{kn}_v1"] = timed(old, problem, st, n)[1]
                del old
            finally:
                mod._DEFAULT_VARIANT = default
            for sname, st, n in (("init", init, GRAPH_SWEEPS), ("converged", conv, conv_n)):
                rec[sname]["graph_ms_again"] = timed(graph, problem, st, n)[1]
            keys = ("graph_ms", f"graph_ms_{kn}_v1", "graph_ms_again")
            log(f"  {path} graph, ms a sweep with {kn.upper()} v2 / v1 / v2 again: from init "
                + " / ".join(f"{rec['init'][k]:.4f}" for k in keys) + ", converged "
                + " / ".join(f"{rec['converged'][k]:.4f}" for k in keys))
        if path in ("tpu_fast", "tpu_fast_super"):
            # POLL: ms a sweep of the converged 300-sweep segment at each cadence
            polls = rec["ms_by_POLL"] = {}
            chosen = pg.POLL
            try:
                for poll in GRAPH_POLLS:
                    pg.POLL = poll
                    polls[poll] = min(timed(graph, problem, conv, GRAPH_SWEEPS)[1]
                                      for _ in range(3))
            finally:
                pg.POLL = chosen
            log(f"  {path} graph, converged, ms a sweep by POLL (best of 3): {polls}")
        if path == "tpu_fast":
            # an early stop inside a poll window: from the state after `skip`
            # sweeps, tor between the |dmu| of sweep k + 1 and the least of the k
            # before it (k = 6 where the trace allows)
            trace = host(problem, init, 40)[3].cpu().numpy()
            found = stop_point(trace, 30, pg.POLL)
            if found is None:
                require(False, f"graph early stop: no sweep whose |dmu| is a new minimum "
                               f"inside a window, trace {trace.tolist()}")
            else:
                skip, k = found
                tor = float((trace[skip + k] + trace[skip:skip + k].min()) / 2)
                start = host(problem, init, skip)[0] if skip else init
                scfg = dataclasses.replace(cfg, tor=tor)
                h, _, h_counts = timed(pg.SegmentRunner(scfg, (H, W), _route="host"),
                                       problem, start, 30)
                sg = pg.make_segment_runner(scfg, (H, W))
                g, _, g_counts = timed(sg, problem, start, 30)
                rec["early_stop"] = dict(skip=skip, tor=tor, n=g[1], stopped=g[5],
                                         host_launches=h_counts, graph_launches=g_counts,
                                         polls=sg.polls)
                by_path["graph tpu_fast early stop (30 asked)"] = g_counts
                require(h[1] == k + 1 and h[5] and same(h, g),
                        f"graph early stop at tor {tor:.6e} after {skip} sweeps: host n {h[1]} "
                        f"(want {k + 1}), graph n {g[1]}, stopped {h[5]} {g[5]}, state and "
                        "traces bit for bit")
                log(f"  tpu_fast early stop: from the state after {skip} sweeps, tor {tor:.6e} "
                    f"stops both runners after sweep {g[1]} of 30; launches host {h_counts}, "
                    f"graph {g_counts} (the window's {min(pg.POLL, 30)} replays), "
                    f"{sg.polls} read(s)")
                del sg
        del host, graph, problem
        torch.cuda.empty_cache()
    # every other single-process configuration: 3 sweeps from the init, the
    # graph bit for bit the host loop's, with its launch counts
    others = {
        "legacy_v1": GQMAPConfig.legacy_v1(quad_var=0.05),
        "legacy_v2": GQMAPConfig.legacy_v2(),
        "legacy_v2 autodiff": GQMAPConfig.legacy_v2(gradient_estimator="autodiff"),
        "tpu_fast autodiff": GQMAPConfig.tpu_fast(gradient_estimator="autodiff"),
        "full_mixture autodiff": GQMAPConfig.full_mixture(gradient_estimator="autodiff"),
        "legacy_v3": GQMAPConfig.legacy_v3(),
        "blockmatch_v2": GQMAPConfig.blockmatch_v2(),
        "tpu_fast window_rg=2": GQMAPConfig.tpu_fast(window_rg=2),
        "tpu_fast chebyshev": GQMAPConfig.tpu_fast(data_term="chebyshev"),
        "tpu_fast float64": GQMAPConfig.tpu_fast(dtype="float64"),
    }
    for path, base in others.items():
        cfg = dataclasses.replace(base, its=100000, eval_every=10, tor=0.0)
        problem = pg.make_problem(cfg, I1, I2, fr, dev)
        if cfg.data_term == "quadratic":  # the prior: the pair's shift
            problem = problem._replace(init_flow=torch.stack(
                [torch.ones_like(problem.I1), torch.zeros_like(problem.I1)], -1))
        init = pg.init_state(cfg, fr, (H, W), seed=0, device=dev)
        h, _, h_counts = timed(pg.SegmentRunner(cfg, (H, W), _route="host"), problem,
                               init, 3)
        graph = pg.make_segment_runner(cfg, (H, W))
        g, _, g_counts = timed(graph, problem, init, 3)
        out.setdefault("others", {})[path] = dict(capture_s=graph.capture_s,
                                                  launches=g_counts)
        by_path[f"graph {path} (3 sweeps)"] = g_counts
        require(graph.route == "graph" and same(h, g) and g_counts == h_counts,
                f"graph {path}: route {graph.route!r}, 3 sweeps bit for bit the host loop's, "
                f"launches {g_counts} (host {h_counts}); capture {graph.capture_s:.3f} s")
        del graph, problem
        torch.cuda.empty_cache()
    out["phase_s"] = time.time() - t_phase
    log(f"  phase graph segments {out['phase_s']:.1f} s")


# the K8 route's paths (models/gqmap._update_route): every single-device Stein
# or Prewitt preset, each node form (K1's mode sums, a GQRaw, K7's chain) and
# edge form (K2's gradients, raw sums), Jacobi and red-black
UPDATE_PATHS = {
    "tpu_fast": GQMAPConfig.tpu_fast(),
    "tpu_fast redblack": GQMAPConfig.tpu_fast(sweep_order="redblack"),
    "tpu_fast_super": GQMAPConfig.tpu_fast_super(),
    "full_mixture": GQMAPConfig.full_mixture(quad_chunk=27),
    "super_entropy": GQMAPConfig.super_entropy(),
    "ctf_level": GQMAPConfig.ctf_level(),
    "legacy_v1": GQMAPConfig.legacy_v1(quad_var=0.05),
    "legacy_v2": GQMAPConfig.legacy_v2(),
    "legacy_v3": GQMAPConfig.legacy_v3(),
    "blockmatch_v2": GQMAPConfig.blockmatch_v2(),
    "tpu_fast window_rg=2": GQMAPConfig.tpu_fast(window_rg=2),
    "tpu_fast chebyshev": GQMAPConfig.tpu_fast(data_term="chebyshev"),
    "full_mixture chebyshev": GQMAPConfig.full_mixture(quad_chunk=27, **CHEB),
    "full_mixture window_rg=2": GQMAPConfig.full_mixture(quad_chunk=27, window_rg=2),
}
UPDATE_TIMED = ("tpu_fast", "full_mixture", "super_entropy", "legacy_v3")  # K8's shapes timed
UPDATE_SWEEPS = 100  # the graph sweeps' segments, in turns
UPDATE_SOLVE_ITS = 300  # the solves held bit for bit to the plain glue's (alpha_start 500)
# K9's alpha step (it = alpha_start + 1) in both alpha_update modes: (path, L);
# legacy_v1 at twenty components, since K9 takes any L
UPDATE_ALPHA = (("tpu_fast", 3), ("tpu_fast redblack", 3), ("full_mixture", 3),
                ("legacy_v1", 20))
# kernels of one sweep under replay on the K8 route, v2 (K1 or K4, K2 or K3, K8):
# tpu_fast and full_mixture; 3 more where softmax stays in torch (alpha not carried)
UPDATE_LAUNCH_LIMIT = 4
UPDATE_LAUNCH_LIMIT_EXACT = 5
UPDATE_LAUNCH_LIMIT_V1 = 20  # v1: K9 a launch, the step, softmax, K1's stack, a copy
UPDATE_CARRY_SWEEPS = 3  # device-loop sweeps whose carry is held to its torch expressions
# legacy_v1's extra turns: K10 and K11 v1 (then v2 again, the first turn's
# runner), K8 v2 around the plain versions of K10 and K11 (the sweep before
# K10 and K11), and node_kernel = edge_kernel = "torch" (the plain sums and the
# plain glue)
QUAD_TURNS = ("K10/K11 v1", "plain sums", "torch routes")
QUAD_REPLAY_KERNELS = 4  # legacy_v1's sweep under replay: K10, K11, K8 v2, the lattice's copy


def update_problem(pg, cfg, fr, dev, pair):
    """``make_problem`` on the synthetic pair; ``legacy_v1``'s prior is the
    pair's shift."""
    p = pg.make_problem(cfg, *pair[:2], fr, dev)
    if cfg.data_term == "quadratic":
        p = p._replace(init_flow=torch.stack([torch.ones_like(p.I1), torch.zeros_like(p.I1)],
                                             -1))
    return p


def update_probes(pg, cfg, fr, dev):
    """The init, random means (sigma 0.05, means over the flow range, |rho|
    and |p| up to 0.9) and the |rho| clamp (every correlation at
    +-corr_tor, sigma in [0.01, 3])."""
    st = pg.init_state(cfg, fr, (H, W), seed=0, device=dev)
    g = torch.Generator(device=dev).manual_seed(7)

    def u(lo, hi, like):
        return lo + (hi - lo) * torch.rand(like.shape, generator=g, dtype=like.dtype,
                                           device=dev)

    def sign(like):
        return torch.where(u(0, 1, like) < 0.5, -1.0, 1.0).to(like.dtype)

    ct = cfg.corr_tor
    return {"init": st,
            "random means": st._replace(
                muu=u(fr.minu, fr.maxu, st.muu), muv=u(fr.minv, fr.maxv, st.muv),
                sigmau=torch.full_like(st.sigmau, 0.05), sigmav=torch.full_like(st.sigmav, 0.05),
                pn=u(-0.9, 0.9, st.pn), rou=u(-0.9, 0.9, st.rou)),
            "clamp": st._replace(rou=sign(st.rou) * ct, pn=sign(st.pn) * ct,
                                 sigmau=u(0.01, 3, st.sigmau), sigmav=u(0.01, 3, st.sigmav))}


def alpha_probe(st, cfg, dev):
    """``st`` one sweep past ``alpha_start``, so K9 takes the alpha step, with
    mixture weights drawn for ``cfg.alpha_update``: logits in [-1, 1], or a
    point of the simplex."""
    g = torch.Generator(device=dev).manual_seed(13)
    r = torch.rand(cfg.L, generator=g, dtype=st.w.dtype, device=dev)
    w = 2 * r - 1 if cfg.alpha_update == "softmax_natural" else (r + 0.1) / (r + 0.1).sum()
    return st._replace(w=w, it=torch.full_like(st.it, cfg.alpha_start + 1))


def capture_update(pg, su, cfg, problem, st, variant="v2"):
    """One sweep of ``cfg`` on the K8 route through K8 ``variant``: each K8
    launch's arguments and outputs (both passes in red-black; v2's last
    with its tail), then K9 v1's where it launches."""
    calls = []

    def site(*a, **k):
        out = su.site_update_cuda(*a, **k)
        calls.append((a, k, out))
        return out

    def tail(*a, **k):
        out = su.sweep_tail_cuda(*a, **k)
        calls.append((a, k, out))
        return out

    kept, kv = pg._UPDATE["K8"], pg.UPDATE_VARIANT["K8"]
    pg._UPDATE["K8"], pg.UPDATE_VARIANT["K8"] = (site, tail), variant
    try:
        pg.make_sweep(cfg, (H, W))(problem, st)
    finally:
        pg._UPDATE["K8"], pg.UPDATE_VARIANT["K8"] = kept, kv
    return calls


def site_mask(interior, colour):
    """The pass's site mask of the plain glue: the interior, of one colour."""
    if colour is None:
        return interior
    M, N = interior.shape
    red = torch.as_tensor((np.add.outer(np.arange(M), np.arange(N)) & 1) == colour,
                          device=interior.device)
    return interior & red


def to64(x):
    """A K8 argument in float64 (tensors, NodeSums, EdgeSums, states; K1's
    coefficient field stays as it is: only its box is read)."""
    if type(x).__name__ == "CosData":
        return x
    if isinstance(x, torch.Tensor):
        return x.double() if x.is_floating_point() else x
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(to64(v) for v in x))
    if isinstance(x, tuple):
        return tuple(to64(v) for v in x)
    return x


def sum_scales(su, node, edge, state, alpha, T, interior):
    """The energy's and dalpha's terms' magnitudes, summed in float64: the
    yardstick of a summation order."""
    a3 = alpha.double().reshape(-1, 1, 1)
    node, edge, state, T = to64(node), to64(edge), to64(state), T.double()
    gn = su.node_grads_torch(node, a3, state, T)
    mu = torch.stack([state.muu, state.muv])
    sg = torch.stack([state.sigmau, state.sigmav])
    ge = su.edge_grads_torch(edge, a3, mu, sg, state.rou, T)
    zero = torch.zeros((), dtype=torch.float64, device=a3.device)
    e = (torch.where(interior, gn.E.abs(), zero).sum()
         + torch.where(interior, ge.E.abs(), zero).sum())
    d = (torch.where(interior, gn.da.abs(), zero).sum((-2, -1))
         + torch.where(interior, ge.da.abs(), zero).sum((0, 1, -2, -1)))
    return e, d


def same_bits(x, y):
    return bool(torch.equal(torch.isnan(x), torch.isnan(y))
                and torch.equal(torch.nan_to_num(x), torch.nan_to_num(y)))


def check_update(pg, su, label, calls, dtype):
    """Each K8 launch's new state against the plain glue's on the same
    arguments, bit for bit (a v2 launch's also against K8 v1's on them);
    the tail's sums (energy, |dmu|, |dsigma|, dalpha; K9 v1's, or v2's in K8's
    last CTA) against the plain sums: float64 within 1e-12 of the terms'
    summed magnitudes, float32 by the ratio rule against the float64 golden
    (the kernel's error at most twice the plain version's, plus 2^-22 of the
    terms' magnitudes); w, T and it bit for bit. Returns (largest state
    difference, the sums' worst error over its allowance). Past
    ``alpha_start`` w moves by dalpha and is held to the plain w by the sums'
    rule, with sum |w| + 2 lr x dalpha's terms' magnitudes as its magnitude
    (the softmax and the projection's threshold sum over the components;
    their change of w is at most twice lr x dalpha's)."""
    v2 = calls[-1][1].get("variant") == "v2"
    k8 = calls if v2 else calls[:-1]
    sums, golds, worst_state, scales, same_v1 = [], [], 0.0, None, True
    for a, k, out in k8:
        planes, part = out[:2]
        node, edge, state, alpha, T, step, interior, cfg, rng = a
        mask = site_mask(interior, k.get("colour"))
        new, s = su.site_update_torch(node, edge, state, alpha, T, step, interior, mask, cfg,
                                      rng)
        for f, x in zip(("muu", "muv", "sigmau", "sigmav", "pn", "rou"),
                        su.lattice_views(planes)):
            y = getattr(new, f)
            diff = float((x.double() - y.double()).abs().nan_to_num(float("inf")).max())
            worst_state = max(worst_state, 0.0 if same_bits(x, y) else max(diff, 1e-300))
        if v2:  # K8 v1 on the same arguments
            p1, _ = su.site_update_cuda(*a, variant="v1", **{q: k[q] for q in
                                                             ("colour", "active", "stop")
                                                             if q in k})
            same_v1 &= same_bits(p1, planes)
        sums.append(s)
        if dtype == torch.float32:
            golds.append(su.site_update_torch(
                to64(node), to64(edge), to64(state), alpha.double(), T.double(),
                step.double(), interior, mask, cfg, rng)[1])
        scales = sum_scales(su, node, edge, state, alpha, T, interior)
    if v2:
        a, k, out = k8[-1]
        tail = k["tail"]
        st0, n_int, step, cfg = tail.state, tail.n_interior, a[5], a[7]
        w, T, it, aux = out[2]
    else:
        parts, st0, step, cfg, n_int = calls[-1][0]
        w, T, it, aux = calls[-1][2]
    pw, pT, pit, paux = su.sweep_tail_torch(sums, st0, step, cfg, n_int)
    order = True
    if v2:  # the tail's sums: their fixed order's, bit for bit, from the kernel's own partials
        e, da, dm, ds = su.v2_tail_sums(k8[-1][2][1], k8[0][2][1] if len(k8) == 2 else None)
        nt = torch.tensor(float(n_int), dtype=e.dtype, device=e.device)
        order = all(same_bits(a_, b_) for a_, b_ in zip(aux, (e, dm / nt, ds / nt, da)))
        require(order, f"update {label}: the tail's sums are their order's (v2_tail_sums on "
                       f"K8 v2's partials) bit for bit")
    stepped = cfg.L > 1 and int(st0.it) > cfg.alpha_start
    same_tail = (torch.equal(T, pT) and torch.equal(it, pit)
                 and (stepped or torch.equal(w, pw)))
    bits = "T and it" if stepped else "w, T and it"
    also = " and K8 v1's" if v2 else ""
    require(same_tail and worst_state == 0.0 and same_v1,
            f"update {label}: K8's new state is the plain glue's bit for bit "
            f"(largest difference {worst_state:.3e}){also} ({same_v1}); the tail's {bits} too "
            f"({same_tail})")
    e_scale, d_scale = scales
    w_mag = (pw.double().abs().sum()
             + 2.0 * float(step) * cfg.alpha_lr_scale * float(torch.as_tensor(d_scale).max()))
    allow = [e_scale, float(aux[1]) * n_int, float(aux[2]) * n_int, d_scale]
    got = [aux[0], aux[1] * n_int, aux[2] * n_int, aux[3]]
    want = [paux[0], paux[1] * n_int, paux[2] * n_int, paux[3]]
    if stepped:
        got, want, allow = got + [w], want + [pw], allow + [w_mag]
    if dtype == torch.float32:
        gw, _, _, gaux = su.sweep_tail_torch(golds, to64(st0), step.double(), cfg, n_int)
        gold = [gaux[0], gaux[1] * n_int, gaux[2] * n_int, gaux[3]] + ([gw] if stepped else [])
        worst = max(float(((g_ - gd).abs() / (2.0 * (p_ - gd).abs() + 2.0 ** -22 * sc)).max())
                    for g_, p_, gd, sc in zip(got, want, gold,
                                              [torch.as_tensor(x) for x in allow]))
        rule = "kernel error <= 2 x plain error + 2^-22 x the terms' magnitudes"
    else:
        worst = max(float(((g_ - p_).abs() / (1e-12 * torch.as_tensor(sc, device=p_.device)
                                              + 1e-300)).max())
                    for g_, p_, sc in zip(got, want, allow))
        rule = "within 1e-12 of the terms' magnitudes"
    what = "energy, |dmu|, |dsigma| and dalpha sums" + (" and the w they step" if stepped
                                                        else "")
    require(worst <= 1.0, f"update {label}: the tail's {what} {rule} (worst {worst:.3f} of "
                          f"it; {'v2, in K8' if v2 else 'K9 v1'})")
    if stepped:
        moved = float((pw - st0.w).abs().max())
        require(moved > 0.0, f"update {label}: the alpha step moved w (largest change "
                             f"{moved:.3e})")
    return worst_state, worst


def check_carry(pg, label, cfg, problem, st, sweeps=UPDATE_CARRY_SWEEPS):
    """The device loop through K8 v2 (eager predicated sweeps, as a graph
    replays them): after each sweep the carry (the step, alpha, K1's phase
    stack, the neighbour stacks) is bit for bit what ``sweep.carry`` builds
    from the new state by the torch expressions; with the stop flag set, a
    sweep leaves state and carry as they were. Returns the carry's fields."""
    seg = pg.SegmentRunner(cfg, (H, W), _route="predicated")
    sto, loop = seg._buffers(st, 4, problem)
    require(len(loop) == 5, f"carry {label}: the device loop carries ({len(loop)} entries)")
    carry = loop[4]
    ok, first_bad = True, None
    for k in range(sweeps + 1):
        if k == sweeps:  # the stop flag holds: nothing may move
            loop[1].fill_(True)
            before = [x.clone() for x in sto] + [x.clone() for x in carry if x is not None]
        pg._predicated_step(seg.sweep, problem, sto, loop)
        fresh = seg.sweep.carry(problem, sto)
        for f, x, y in zip(carry._fields, carry, fresh):
            if x is not None and not torch.equal(x, y):
                ok, first_bad = False, first_bad or (k, f)
        if k == sweeps:
            after = [x for x in sto] + [x for x in carry if x is not None]
            ok &= all(torch.equal(x, y) for x, y in zip(before, after))
    fields = [f for f, x in zip(carry._fields, carry) if x is not None]
    require(ok, f"carry {label}: {fields} bit for bit their torch expressions after each of "
                f"{sweeps} sweeps, and unchanged under the stop flag (first off: {first_bad})")
    return fields


def update_phase(dev, record, by_path, ufns):
    """Phase 30b: the sweep's update, kernels K8 (v2, the default, with K9's
    tail in its last CTA; v1 and K9 v1 beside) against their plain versions
    (``kernels/sweep_update.site_update_torch``, ``sweep_tail_torch``) on
    every path of :data:`UPDATE_PATHS` in float32 and float64 at the init,
    random-means and |rho|-clamp probes: from the same state with the same
    node and edge kernels' outputs, K8 v2's new state bit for bit the plain
    glue's and K8 v1's, the tail's sums within their order
    (:func:`check_update`), and one sweep past ``alpha_start`` in both
    alpha modes through v2 and v1; the device loop's carry bit for bit its
    torch expressions (:func:`check_carry`), and PyTorch's reduction order
    (``sweep_update.card_sum``) for 1 to 64 values; 300-sweep ``tpu_fast``
    and ``full_mixture`` solves (``tor = 0``, stopping before ``alpha_start
    = 500``) through v2, v1 and the plain glue, their final states bit for
    bit; K8 v2's time (:data:`UPDATE_TIMED`; with and without the tail and
    the carry), v1's and K9 v1's beside the plain versions' and the bounds;
    each path's graph sweep in turns (v2, v1, the plain glue, v2 again)
    with the capturing call's peak memory. (One replay's kernels and the
    idle share are profiled in the last phase.)"""
    from gqmap_tpu_torch import FlowRange, solve
    from gqmap_tpu_torch.kernels import quad_gq
    from gqmap_tpu_torch.kernels import sweep_update as su
    from gqmap_tpu_torch.models import gqmap as pg

    log("phase update (K8, K9: v2 and v1)")
    t_phase = time.time()
    fr = FlowRange(*FR)
    pair = synthetic_pair()
    I1, I2, gt = pair
    out = record["update"] = {"card": smi("name,power.limit")}
    plain_route = pg._update_route

    def force_plain():
        pg._update_route = lambda cfg, dist, device: "plain"

    def restore():
        pg._update_route = plain_route
        pg.UPDATE_VARIANT["K8"] = "v2"

    # ---- PyTorch's reduction order of e.sum(), which K9 v2's alpha carry takes
    bad = {}
    g = torch.Generator(device=dev).manual_seed(1)
    for dtype in (torch.float32, torch.float64):
        for L in range(1, su.MAX_CARRY_L + 1):
            for trial in range(20):
                e = torch.exp((torch.rand(L, generator=g, dtype=dtype, device=dev) * 12 - 6)
                              * 10.0 ** (trial % 4 - 2))
                if not torch.equal(e.sum(), su.card_sum(e)):
                    bad.setdefault(str(dtype)[6:], []).append(L)
                    break
    out["card_sum_mismatch"] = bad
    require(not bad, f"card_sum is the card's e.sum() order for 1 to {su.MAX_CARRY_L} values, "
                     f"both types, 20 draws each (mismatch at {bad})")

    # ---- K8 v2 (and v1) against the plain glue, every path, both types, three probes
    checks = out["checks"] = {}
    for path, base in UPDATE_PATHS.items():
        for dtype in (torch.float32, torch.float64):
            cfg = dataclasses.replace(base, dtype=str(dtype)[6:])
            require(pg._update_route(cfg, None, dev) == "K8", f"update {path}: route K8")
            problem = update_problem(pg, cfg, fr, dev, pair)
            for probe, st in update_probes(pg, cfg, fr, dev).items():
                calls = capture_update(pg, su, cfg, problem, st)
                passes = 2 if cfg.sweep_order == "redblack" else 1
                require(len(calls) == passes and "tail" in calls[-1][1],
                        f"update {path}: {passes} K8 v2 launches a sweep, the last with the "
                        f"tail, no K9 launch ({len(calls)} calls)")
                label = f"{path} {str(dtype)[6:]} {probe}"
                checks[label] = check_update(pg, su, label, calls, dtype)
                del calls
                if probe == "random means":
                    check_carry(pg, label, cfg, problem, st)
            del problem
            torch.cuda.empty_cache()
    # ---- the alpha step, both modes, from the random-means probe: v2 and v1, and the
    # carry's step and alpha after it
    for path, L in UPDATE_ALPHA:
        for dtype in (torch.float32, torch.float64):
            for mode in ("softmax_natural", "projsplx"):
                cfg = dataclasses.replace(UPDATE_PATHS[path], dtype=str(dtype)[6:], L=L,
                                          alpha_update=mode)
                problem = update_problem(pg, cfg, fr, dev, pair)
                st = alpha_probe(update_probes(pg, cfg, fr, dev)["random means"], cfg, dev)
                for variant in ("v2", "v1"):
                    label = f"{path} L={L} {str(dtype)[6:]} alpha step {mode} {variant}"
                    checks[label] = check_update(
                        pg, su, label, capture_update(pg, su, cfg, problem, st, variant), dtype)
                check_carry(pg, f"{path} L={L} {str(dtype)[6:]} alpha step {mode}", cfg,
                            problem, st)
                del problem, st
                torch.cuda.empty_cache()
    log(f"  K8 v2 (and v1) against the plain glue on {len(checks)} path, type and probe "
        f"cases: largest state difference {max(v[0] for v in checks.values()):.3e}, worst sum "
        f"{max(v[1] for v in checks.values()):.3f} of its allowance; carries held")

    # ---- 300-sweep solves through v2, v1 and the plain glue, bit for bit
    for path in ("tpu_fast", "full_mixture"):
        cfg = dataclasses.replace(UPDATE_PATHS[path], its=UPDATE_SOLVE_ITS,
                                  eval_every=UPDATE_SOLVE_ITS, tor=0.0)
        res, secs, counts = {}, {}, {}
        for route in ("v2", "v1", "plain"):
            for f in ufns.values():
                f.launches = 0
            if route == "plain":
                force_plain()
            pg.UPDATE_VARIANT["K8"] = "v1" if route == "v1" else "v2"
            try:
                t = time.time()
                res[route] = solve(cfg, I1, I2, gt_flow=gt, flow_range=fr, device=dev)
                secs[route] = time.time() - t
            finally:
                restore()
            counts[route] = {k: f.launches for k, f in ufns.items()}
        by_path[f"update {path} solve ({UPDATE_SOLVE_ITS} sweeps)"] = dict(counts["v2"])
        same = {r: all(torch.equal(getattr(res["plain"].state, f), getattr(res[r].state, f))
                       for f in res[r].state._fields) for r in ("v2", "v1")}
        e_rel = float(np.max(np.abs(res["v2"].Energy - res["plain"].Energy)
                             / np.abs(res["plain"].Energy)))
        n = UPDATE_SOLVE_ITS
        require(all(r.iters == n for r in res.values()) and all(same.values())
                and counts["v2"] == {"K8": n, "K9": n, "K9 v1": 0}
                and counts["v1"] == {"K8": n, "K9": 0, "K9 v1": n},
                f"update {path}: {n}-sweep solves (tor 0) through K8 v2 and v1 end in the plain "
                f"glue's state bit for bit ({same}); launches {counts}; v2's energy trace "
                f"within {e_rel:.3e} (summation order); AEPE "
                f"{[round(float(r.AEPE[n - 1]), 6) for r in res.values()]}")
        out[f"{path} solve"] = dict(seconds=secs, same_state=same, energy_rel=e_rel)
        del res
    torch.cuda.empty_cache()

    # ---- K8's and K9's times beside their plain versions' and bounds (f32)
    for path in UPDATE_TIMED:
        cfg = UPDATE_PATHS[path]
        problem = update_problem(pg, cfg, fr, dev, pair)
        st = update_probes(pg, cfg, fr, dev)["random means"]
        calls = capture_update(pg, su, cfg, problem, st)
        a, k, (planes, part, tail_out) = calls[0]
        node, edge, state, alpha, Tt, step, interior, c, rng = a
        L, M, N = state.muu.shape
        mask = site_mask(interior, k.get("colour"))
        bare = {q: k[q] for q in ("colour", "active", "stop") if q in k}
        carry = su.Carry(torch.empty_like(step), torch.empty_like(alpha)
                         if c.alpha_update == "softmax_natural" else None,
                         torch.empty((5, L, M, N), dtype=alpha.dtype, device=dev)
                         if node.form == "modes" else None,
                         *((torch.empty_like(state.rou), torch.empty_like(state.rou))
                           if edge.form == "raw" else (None, None)))
        # the same bits on every run and at every grid: the tail's CTA varies, nothing else
        outs = [su.site_update_cuda(*a, **{**k, "max_ctas": mc}) for mc in (0, 0, 5)]

        def flat(o):
            return [o[0], o[1], *o[2][:3], *o[2][3]]

        same_grid = all(same_bits(x, y) for o in outs[1:] for x, y in zip(flat(outs[0]), flat(o)))
        require(same_grid, f"update {path}: K8 v2 and its tail give the same bits on two runs "
                           f"at the default grid and one of 5 CTAs")
        del outs
        ms = kernel_ms(lambda: su.site_update_cuda(*a, **bare, variant="v2"))
        ms_tail = kernel_ms(lambda: su.site_update_cuda(*a, **k))
        ms_carry = kernel_ms(lambda: su.site_update_cuda(*a, **{**k, "carry": carry}))
        ms_v1 = kernel_ms(lambda: su.site_update_cuda(*a, **bare, variant="v1"))
        _, part1 = su.site_update_cuda(*a, **bare, variant="v1")
        tail = k["tail"]
        targs = ([part1], tail.state, step, c, tail.n_interior)
        k9_v1 = kernel_ms(lambda: su.sweep_tail_cuda(*targs))
        pms = time_ms(lambda: su.site_update_torch(node, edge, state, alpha, Tt, step, interior,
                                                   mask, c, rng), 5)
        sums = su.site_update_torch(node, edge, state, alpha, Tt, step, interior, mask, c,
                                    rng)[1]
        tpms = time_ms(lambda: su.sweep_tail_torch([sums], *targs[1:]), 5)
        site_shape = tuple(state.muu.shape)
        # the bound: the bytes the function must move (each input read once, each
        # output written once: k8_work's v1 count); v2's own traffic, with each
        # tile's halo read again, beside it
        k8 = dict(variant="v2", ms=ms[0], ms_min=ms[1], ms_with_tail=ms_tail[0],
                  ms_with_tail_and_carry=ms_carry[0], ms_v1=ms_v1[0], plain_ms=pms,
                  library_ms=None, forms=(node.form, edge.form), shape=site_shape,
                  **bound(roofline.k8_work(site_shape, node.form, edge.form)))
        k8["bound_ms_v2_traffic"] = bound(roofline.k8_work(site_shape, node.form, edge.form,
                                                           variant="v2"))["bound_ms"]
        k8["bound_ms_with_carry"] = bound(roofline.k8_work(site_shape, node.form, edge.form,
                                                           variant="v2", carry=True))["bound_ms"]
        k9 = dict(variant="v2 (K8 v2's last CTA)", ms=ms_tail[0] - ms[0], ms_v1=k9_v1[0],
                  ms_v1_min=k9_v1[1], plain_ms=tpms, library_ms=None,
                  **bound(roofline.k9_work(L, M, N, variant="v2")))
        k9["bound_ms_v1"] = bound(roofline.k9_work(L, M, N))["bound_ms"]
        out[f"K8 {path}"], out[f"K9 {path}"] = k8, k9
        log(f"  {path} f32 ({node.form}, {edge.form}) at {site_shape} on {out['card']}, "
            f"(median, min) of {TIMING[0]} windows of {TIMING[1]}: K8 v2 {ms} ms "
            f"({k8['bound_ms'] / ms[0]:.1%} of {fmt_bound(k8)}; of v2's traffic with the "
            f"halo's re-reads, {k8['bound_ms_v2_traffic']:.4f} ms, "
            f"{k8['bound_ms_v2_traffic'] / ms[0]:.1%}), with the tail {ms_tail[0]:.4f}, with "
            f"tail and carry {ms_carry[0]:.4f} (bound {k8['bound_ms_with_carry']:.4f}); K8 v1 "
            f"{ms_v1} ({k8['bound_ms'] / ms_v1[0]:.1%}); plain {pms:.4f}; K9 v2 in K8 "
            f"{k9['ms']:.4f}, "
            f"K9 v1 {k9_v1} (bound {k9['bound_ms_v1']:.2e}), plain {tpms:.4f}")
        if path == "tpu_fast":
            worst_state, _ = check_update(pg, su, "tpu_fast f32 random means (timed)", calls,
                                          torch.float32)
            record["K8"] = dict(k8, max_abs_err=worst_state)
            pw, pT, pit, paux = su.sweep_tail_torch([sums], *targs[1:])
            record["K9"] = dict(k9, max_abs_err=max(float((x - y).abs().max())
                                                    for x, y in zip(tail_out[3], paux)))
            record["K9 v1"] = dict(ms=k9_v1[0], plain_ms=tpms, bound_ms=k9["bound_ms_v1"])
        elif path == "super_entropy":
            record["super"] = dict(record.get("super", {}), K8=k8, K9=k9)
        del calls, problem
        torch.cuda.empty_cache()

    # ---- each path's graph sweep in turns: v2, v1, plain glue, v2 again
    turns = out["graph_ms"] = {}
    names = ("K1", "K2", "K3", "K4", "K5", "K6", "K7", "K8", "K9 v1", "K9", "K10", "K11", "K12")
    for path, base in UPDATE_PATHS.items():
        cfg = dataclasses.replace(base, its=100000, eval_every=UPDATE_SWEEPS, tor=0.0)
        problem = update_problem(pg, cfg, fr, dev, pair)
        st = pg.init_state(cfg, fr, (H, W), seed=0, device=dev)
        st = st._replace(sigmau=torch.full_like(st.sigmau, 0.05),
                         sigmav=torch.full_like(st.sigmav, 0.05))
        runners, peaks = {}, {}
        routes = ("v2", "v1", "plain") + (QUAD_TURNS if path == "legacy_v1" else ())
        for route in routes:
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            held = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            if route == "plain":
                force_plain()
            pg.UPDATE_VARIANT["K8"] = "v1" if route == "v1" else "v2"
            kept = dict(pg._NODE_QUAD), dict(pg._EDGE_ROUTES["K11"]), quad_gq._DEFAULT_VARIANT
            if route == "plain sums":  # K8 v2 around the plain versions of K10 and K11
                pg._NODE_QUAD["auto"] = quad_gq.quad_node_gq_torch
                pg._EDGE_ROUTES["K11"]["auto"] = quad_gq.truncquad_edge_gq_torch
            if route == "K10/K11 v1":
                quad_gq._DEFAULT_VARIANT = "v1"
            rcfg = (dataclasses.replace(cfg, node_kernel="torch", edge_kernel="torch")
                    if route == "torch routes" else cfg)
            try:
                seg = runners[route] = pg.make_segment_runner(rcfg, (H, W))
                seg(problem, st, 10)  # the capture
            finally:
                restore()
                pg._NODE_QUAD.update(kept[0])
                pg._EDGE_ROUTES["K11"].update(kept[1])
                quad_gq._DEFAULT_VARIANT = kept[2]
            torch.cuda.synchronize()
            peaks[route] = (torch.cuda.max_memory_allocated() - held) / 2**30
            require(seg.route == "graph", f"update {path} {route}: route {seg.route!r}")
        ms = {}
        again = ("K10/K11 v2 again",) if path == "legacy_v1" else ()
        for route in routes[:3] + ("v2 again",) + routes[3:4] + again + routes[4:]:
            seg = runners["v2" if route in ("v2 again", "K10/K11 v2 again") else route]
            t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t0.record()
            seg(problem, st, UPDATE_SWEEPS)
            t1.record()
            torch.cuda.synchronize()
            ms[route] = t0.elapsed_time(t1) / UPDATE_SWEEPS
        deltas = {r: dict(zip(names, runners[r]._captured.deltas))
                  for r in ("v2", "v1") + routes[3:]}
        turns[path] = dict(ms, capture_GiB_above_held=peaks, counted_launches_a_sweep=deltas)
        log(f"  {path} graph, ms a sweep ({UPDATE_SWEEPS} sweeps from sigma 0.05): v2 "
            f"{ms['v2']:.4f}, v1 {ms['v1']:.4f}, plain glue {ms['plain']:.4f}, v2 again "
            f"{ms['v2 again']:.4f}"
            + "".join(f", {r} {ms[r]:.4f}" for r in routes[3:4] + again + routes[4:])
            + f"; capturing call's peak above held, GiB: {peaks}; counted launches a sweep "
            f"{deltas}")
        if path == "legacy_v1":
            q, q1 = deltas["v2"], deltas["K10/K11 v1"]
            require(q["K10"] == q["K11"] == q1["K10"] == q1["K11"] == 1
                    and deltas["plain sums"]["K10"] == 0,
                    f"update legacy_v1: one K10 and one K11 launch a sweep through the kernels "
                    f"(v2 and v1), none through the plain sums ({deltas})")
        del runners, seg, problem
        torch.cuda.empty_cache()
    out["phase_s"] = time.time() - t_phase
    log(f"  phase update {out['phase_s']:.1f} s")


def profiles_phase(dev, record):
    """Phase 31, the last: the profiler's hooks may stay in the process and
    slow later launches, so nothing is timed after it. One sweep of
    ``tpu_fast``, ``full_mixture`` and the Chebyshev ``full_mixture`` from
    the sigma = 0.05 state under ``torch.profiler`` (:func:`profile_call`),
    and a 20-sweep segment of the first two on the graph route; then one
    ``tpu_fast`` and one ``full_mixture`` graph replay (one sweep) and a
    20-sweep segment through K8 v2, K8 and K9 v1 and the plain glue: the
    kernels a sweep (at most :data:`UPDATE_LAUNCH_LIMIT` and
    :data:`UPDATE_LAUNCH_LIMIT_EXACT` through v2) and the idle share."""
    from gqmap_tpu_torch import FlowRange, GQMAPConfig
    from gqmap_tpu_torch.kernels import quad_gq
    from gqmap_tpu_torch.kernels import sweep_update as su
    from gqmap_tpu_torch.models import gqmap as pg

    log("phase profiles")
    I1, I2, _ = synthetic_pair()
    fr = FlowRange(*FR)
    for label, cfg in (("tpu_fast", GQMAPConfig.tpu_fast()),
                       ("full_mixture", GQMAPConfig.full_mixture(quad_chunk=27)),
                       ("full_mixture chebyshev", GQMAPConfig.full_mixture(quad_chunk=27,
                                                                           **CHEB))):
        problem = pg.make_problem(cfg, I1, I2, fr, dev)
        st = pg.init_state(cfg, fr, (H, W), seed=0, device=dev)
        st = st._replace(sigmau=torch.full_like(st.sigmau, 0.05),
                         sigmav=torch.full_like(st.sigmav, 0.05))
        sweep = pg.make_sweep(cfg, (H, W))
        prof = record.setdefault("profile", {})[label] = profile_call(lambda: sweep(problem, st))
        log(f"  one {label} sweep under torch.profiler: {json.dumps(prof)}")
        if label != "full_mixture chebyshev":
            seg = pg.make_segment_runner(dataclasses.replace(cfg, tor=0.0), (H, W))
            prof = record["profile"][f"{label} graph, 20 sweeps"] = profile_call(
                lambda: seg(problem, st, 20))
            require(seg.route == "graph", f"profiled {label} segment: route {seg.route!r}")
            log(f"  a 20-sweep {label} segment on the graph route under torch.profiler: "
                f"{json.dumps(prof)}")
            del seg
        del problem
        torch.cuda.empty_cache()
    # one sweep under replay, its kernels (K8 v2 in place of the plain glue's ~140 and
    # of v1's 16 around K1, K2, K8, K9), and a 20-sweep segment's idle share, each route
    kept, count = pg._update_route, {}
    for label, cfg in (("tpu_fast", GQMAPConfig.tpu_fast(tor=0.0)),
                       ("full_mixture", GQMAPConfig.full_mixture(quad_chunk=27, tor=0.0))):
        problem = pg.make_problem(cfg, I1, I2, fr, dev)
        st = pg.init_state(cfg, fr, (H, W), seed=0, device=dev)
        st = st._replace(sigmau=torch.full_like(st.sigmau, 0.05),
                         sigmav=torch.full_like(st.sigmav, 0.05))
        carried = cfg.alpha_update == "softmax_natural" and cfg.L <= su.MAX_CARRY_L
        for route in ("v2", "v1", "plain"):
            if route == "plain":
                pg._update_route = lambda c, d, device: "plain"
            pg.UPDATE_VARIANT["K8"] = "v1" if route == "v1" else "v2"
            try:
                seg = pg.make_segment_runner(cfg, (H, W))
                seg(problem, st, 10)
            finally:
                pg._update_route = kept
                pg.UPDATE_VARIANT["K8"] = "v2"
            rep = record["profile"][f"{label} graph replay, {route}"] = profile_call(
                seg._captured.graph.replay)
            seg20 = record["profile"][f"{label} graph, 20 sweeps, {route}"] = profile_call(
                lambda: seg(problem, st, 20))
            count[label, route] = rep["kernels"]
            log(f"  one {label} sweep under replay, {route}: {rep['kernels']} kernels, "
                f"{rep['device_ms']:.4f} ms on the card of {rep['wall_ms']:.4f} wall "
                f"({rep['top_ops_device_ms']}); 20 sweeps: idle {seg20['idle_share']:.1%}, "
                f"{seg20['device_ms']:.3f} ms on the card of {seg20['wall_ms']:.3f}")
            del seg
        limit = {"tpu_fast": UPDATE_LAUNCH_LIMIT, "full_mixture": UPDATE_LAUNCH_LIMIT_EXACT}[label]
        limit += 0 if carried else 3
        require(count[label, "v2"] <= limit,
                f"a {label} sweep under replay launches {count[label, 'v2']} kernels through K8 "
                f"v2 (at most {limit}; v1 {count[label, 'v1']}, the plain glue "
                f"{count[label, 'plain']})")
        if label == "tpu_fast":
            require(count[label, "v1"] <= UPDATE_LAUNCH_LIMIT_V1,
                    f"a tpu_fast sweep under replay launches {count[label, 'v1']} kernels "
                    f"through K8 and K9 v1 (at most {UPDATE_LAUNCH_LIMIT_V1})")
        del problem
        torch.cuda.empty_cache()
    # legacy_v1: one sweep under replay through K10, K11 and K8 v2 (and the raw
    # lattice's copy), and through K8 v2 around the plain versions of K10 and K11
    cfg = GQMAPConfig.legacy_v1(quad_var=0.05, tor=0.0)
    problem = update_problem(pg, cfg, fr, dev, (I1, I2))
    st = pg.init_state(cfg, fr, (H, W), seed=0, device=dev)
    st = st._replace(sigmau=torch.full_like(st.sigmau, 0.05),
                     sigmav=torch.full_like(st.sigmav, 0.05))
    for route in ("kernels", "plain sums"):
        kept_routes = dict(pg._NODE_QUAD), dict(pg._EDGE_ROUTES["K11"])
        if route == "plain sums":
            pg._NODE_QUAD["auto"] = quad_gq.quad_node_gq_torch
            pg._EDGE_ROUTES["K11"]["auto"] = quad_gq.truncquad_edge_gq_torch
        try:
            seg = pg.make_segment_runner(cfg, (H, W))
            seg(problem, st, 10)
        finally:
            pg._NODE_QUAD.update(kept_routes[0])
            pg._EDGE_ROUTES["K11"].update(kept_routes[1])
        rep = record["profile"][f"legacy_v1 graph replay, {route}"] = profile_call(
            seg._captured.graph.replay)
        count["legacy_v1", route] = rep["kernels"]
        log(f"  one legacy_v1 sweep under replay, {route}: {rep['kernels']} kernels, "
            f"{rep['device_ms']:.4f} ms on the card of {rep['wall_ms']:.4f} wall "
            f"({rep['top_ops_device_ms']})")
        del seg
    require(count["legacy_v1", "kernels"] <= QUAD_REPLAY_KERNELS,
            f"a legacy_v1 sweep under replay launches {count['legacy_v1', 'kernels']} kernels "
            f"through K10, K11 and K8 v2 (at most {QUAD_REPLAY_KERNELS}; around the plain sums "
            f"{count['legacy_v1', 'plain sums']})")
    # full_mixture(window_rg=2): one sweep under replay through K12, K3 and K8 v2,
    # full_mixture's kernels with K12 in K4's place; and around the plain sums
    from gqmap_tpu_torch.kernels import window_gq

    cfg = GQMAPConfig.full_mixture(quad_chunk=27, window_rg=2, tor=0.0)
    problem = pg.make_problem(cfg, I1, I2, fr, dev)
    st = pg.init_state(cfg, fr, (H, W), seed=0, device=dev)
    st = st._replace(sigmau=torch.full_like(st.sigmau, 0.05),
                     sigmav=torch.full_like(st.sigmav, 0.05))
    label = "full_mixture window_rg=2"
    for route in ("kernels", "plain sums"):
        kept_routes = dict(pg._NODE_WINDOW)
        if route == "plain sums":
            pg._NODE_WINDOW["auto"] = window_gq.node_window_gq_torch
        try:
            seg = pg.make_segment_runner(cfg, (H, W))
            seg(problem, st, 2)
        finally:
            pg._NODE_WINDOW.update(kept_routes)
        rep = record["profile"][f"{label} graph replay, {route}"] = profile_call(
            seg._captured.graph.replay)
        count[label, route] = rep["kernels"]
        log(f"  one {label} sweep under replay, {route}: {rep['kernels']} kernels, "
            f"{rep['device_ms']:.4f} ms on the card of {rep['wall_ms']:.4f} wall "
            f"({rep['top_ops_device_ms']})")
        del seg
    require(count[label, "kernels"] <= UPDATE_LAUNCH_LIMIT_EXACT,
            f"a {label} sweep under replay launches {count[label, 'kernels']} kernels through "
            f"K12, K3 and K8 v2 (at most {UPDATE_LAUNCH_LIMIT_EXACT}, full_mixture's limit; "
            f"around the plain sums {count[label, 'plain sums']})")
    del problem


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is false)")
    cap = torch.cuda.get_device_capability(0)
    if cap != (9, 0):
        raise SystemExit(f"chip_smoke: needs a Hopper card (capability 9.0), found {cap}")
    from gqmap_tpu_torch import GQMAPConfig, FlowRange, solve
    from gqmap_tpu_torch.kernels import (autodiff_gq, build, cheb_gq, cosine_gq, edge_gq,
                                         edge_reduced_gq, nearest_gq, node_gq, quad_gq,
                                         sweep_update, window_gq)
    from gqmap_tpu_torch.models import gqmap as pg
    from gqmap_tpu_torch.models.blockmatch import block_matching_init
    from gqmap_tpu_torch.ops.gq import EDGE, NODE, finalize
    from gqmap_tpu_torch.ops.interp import upsample_cubic

    dev = torch.device("cuda", 0)
    k1_fn, k2_fn = cosine_gq.cos_mode_sums_cuda, edge_reduced_gq.edge_reduced_grads_cuda
    # K8 (v2 by default), K9 v2 (its tail, counted where K8 v2 launches with it) and
    # K9 v1 (a launch of its own, on the v1 route only)
    ufns = {"K8": sweep_update.site_update_cuda, "K9": sweep_update.sweep_tail_v2,
            "K9 v1": sweep_update.sweep_tail_cuda}
    # kernels counted on every counted run: K10, K11, K12 and the autodiff
    # estimator's K13, K14, K15 and K16
    qfns = {"K10": quad_gq.quad_node_gq_cuda, "K11": quad_gq.truncquad_edge_gq_cuda,
            "K12": window_gq.node_window_gq_cuda, "K13": autodiff_gq.node_chain_gq_cuda,
            "K14": autodiff_gq.edge_chain_gq_cuda, "K15": autodiff_gq.edge_diff_adjoint_cuda,
            "K16": autodiff_gq.node_window_chain_gq_cuda}

    # ---- 1. the card
    card = smi("name,power.limit")
    log(card)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, device "
        f"{torch.cuda.get_device_name(0)}, capability {cap}, count {torch.cuda.device_count()}")

    # ---- 2. the build
    log("phase build")
    t = time.time()
    path, built = build.build_library()
    log(f"  {'built' if built else 'cache hit'} {os.path.relpath(path)} in "
        f"{time.time() - t:.3f} s")
    with open(path[:-3] + ".log") as f:
        for line in f:
            if line.startswith("nvcc "):
                log("  " + line.strip())
            elif "entry function" in line or "registers" in line or "spill" in line:
                log("  ptxas: " + line.strip())
    t = time.time()
    _, built2 = build.build_library()
    require(not built2, f"second build is a cache hit ({time.time() - t:.4f} s)")
    build.load_library()
    sass = sass_per_unit(os.path.join(os.path.dirname(build._find_nvcc()), "cuobjdump"), path)
    max_clock = smi("clocks.max.sm")
    issue_rate = roofline.SMS * LANES_PER_CLOCK * float(max_clock.split()[0]) * 1e6
    RATES["datasheet"] = roofline.datasheet_rates(float(max_clock.split()[0]))
    log(f"  SASS instructions (f32): {sass}; max SM clock {max_clock}. K1: its loop per "
        "mode; K2, K3, K10 and K11: the main path's rule instance, whole function (set-up and "
        "epilogue included) per point, and its MUFU.RSQ count; K10 v2: the function per site; "
        "K11 v2 at K = 9: each mixed form per point of an element in lane instructions (the "
        "per-lane form's basic block, the cooperative form's pass loop); K12: the K = 9, "
        "rg = 2 instance's shared-memory point loop per point (v2: its 16-byte route's "
        "shared-form path); K13-K15 per point and their MUFU a point (K13 v1 its point loop, "
        "v2 the K = 9 shared-memory loop's shared-form path; K14 v1 and K15 v1 the pair loop; "
        "K14 v2 the K = 9 and K15 v2 the K1 = 21 instance's whole function; K16 (K = 9, "
        "rg = 2) and K13 at patch 4 (K = 11) the 16-byte route's point loop on its shared form)")
    for unit in ("K1 recur mode", "K1 exp mode", "K2 point", "K3 point", "K2 rsq", "K3 rsq",
                 "K4 v1 sample", "K4 v2 point P=1", "K4 v2 point P=4", "K5 a-step Q=16",
                 "K5 a-step Q=32", "K5 v2 chunk Q=16 N=96", "K5 v2 chunk Q=16 N=64",
                 "K5 v2 chunk Q=32 N=96", "K6 point rg=2", "K6 point rg=0", "K7 point",
                 "K6 v2 round rg=2", "K6 v2 round rg=0", "K7 v2 round", "K10 point",
                 "K11 point", "K10 v2 site", "K11 v2 lane point", "K11 v2 coop point",
                 "K12 point", "K12 v2 point", "K13 v1 point", "K13 v2 point", "K14 v1 point",
                 "K14 v2 point", "K15 point", "K15 v2 point", "K16 point", "K13 p4 point"):
        require(sass[unit] is not None, f"SASS count found: {unit} {sass[unit]}")

    # ---- 2b. the card's ceilings: the measured rates of bound()
    log("phase ceilings")
    t = time.time()
    ceil = roofline.measure_ceilings(device=dev)
    RATES["measured"] = roofline.measured_rates(ceil)
    sheet = RATES["datasheet"]
    l1_per_clock = ceil["l1_GBps"] * 1e9 / roofline.SMS / (float(max_clock.split()[0]) * 1e6)
    log(f"  TF32 tensor cores: wgmma m64n96k8 {ceil['tc_wgmma_tf32_GFLOPs']:.0f} GFLOP/s (the "
        f"bounds' rate: K5 v2's instruction), mma.sync m16n8k8 {ceil['tc_tf32_GFLOPs']:.0f}")
    log(f"  measured ({time.time() - t:.1f} s): {json.dumps(ceil)} (L1: {l1_per_clock:.2f} "
        f"bytes an SM a clock at the max SM clock); data sheet: "
        f"{roofline.HBM_BYTES_PER_S / 1e9:g} GB/s, {roofline.FP32_FLOPS_PER_S / 1e9:g} GFLOP/s, "
        f"roots {sheet['roots'] / 1e9:g} G/s and L1 {sheet['l1_bytes'] / 1e9:g} GB/s at the max "
        "SM clock")

    def issue_ms(unit, work):
        """The SASS issue bound: ``work`` units of the loop at full issue."""
        return None if sass[unit] is None else work * sass[unit] / issue_rate * 1e3

    I1, I2, gt = synthetic_pair()
    fr = FlowRange(*FR)
    cfg32 = GQMAPConfig.tpu_fast(its=900, eval_every=300)
    cfg64 = GQMAPConfig.tpu_fast(its=900, eval_every=300, dtype="float64")
    k1 = 2 * cfg32.K + 3
    t = time.time()
    prob = {torch.float32: pg.make_problem(cfg32, I1, I2, fr, dev),
            torch.float64: pg.make_problem(cfg64, I1, I2, fr, dev)}
    torch.cuda.synchronize()
    log(f"make_problem f32 + f64 (coefficient fields {tuple(prob[torch.float32].cheb.coeffs.shape)})"
        f": {time.time() - t:.3f} s")
    st64 = pg.init_state(cfg64, fr, (H, W), seed=0, device=dev)
    conv64 = st64._replace(sigmau=torch.full_like(st64.sigmau, 0.05),
                           sigmav=torch.full_like(st64.sigmav, 0.05))

    def cast(st, dtype):
        return pg.GQState(*(x.to(dtype) if x.is_floating_point() else x for x in st))

    # ---- 3. kernels against their plain versions
    log("phase kernels")
    record = {"ceilings": ceil}
    k1_ms = {}
    crop = {dt: pg.make_problem(c, I1[:77, :300], I2[:77, :300], fr, dev)
            for dt, c in ((torch.float32, cfg32), (torch.float64, cfg64))}
    for label, probs in (("77x300", crop), ("376x452", prob)):
        for dtype in (torch.float64, torch.float32):
            p = probs[dtype]
            M, N = p.I1.shape
            A, B = p.cheb.coeffs.shape[:2]
            for sname, st in (("init", st64), ("converged", conv64)):
                s = cast(st, dtype)
                sites = (s.muu[:, :M, :N].contiguous(), s.muv[:, :M, :N].contiguous(),
                         s.sigmau[:, :M, :N].contiguous(), s.sigmav[:, :M, :N].contiguous(),
                         s.pn[:, :M, :N].contiguous())
                want = cosine_gq.cos_mode_sums_torch(p.cheb, *sites)
                for variant in cosine_gq.VARIANTS:
                    cnt = torch.zeros(3, dtype=torch.int64, device=dev)
                    got = k1_fn(p.cheb, *sites, variant=variant, counters=cnt)
                    a, r, ok = compare(got, want, dtype)
                    n_recur, n_exp, modes = cnt.tolist()
                    require(ok, f"K1 {label} {str(dtype)[6:]} {sname} {variant}: max abs err "
                                f"{a:.3e}, rel {r:.3e}; counters: {n_recur} warps recur, "
                                f"{n_exp} exp, {modes} modes of {A * B * sites[0].numel()}")
                    if sname == "converged" and variant == "recur":
                        require(n_exp == 0 and n_recur > 0,
                                f"K1 {label} {str(dtype)[6:]} converged: every warp ran "
                                f"the recur body ({n_recur} recur, {n_exp} exp)")
                    if label == "376x452" and dtype == torch.float32:
                        if variant in ("v1", cosine_gq._DEFAULT_VARIANT):
                            k1_ms[sname, variant] = kernel_ms(
                                lambda: k1_fn(p.cheb, *sites, variant=variant))
                        if sname == "converged" and variant == cosine_gq._DEFAULT_VARIANT:
                            record["K1"] = dict(max_abs_err=a, variant=variant, **bound(
                                roofline.k1_work(p.cheb.coeffs.shape, len(sites[0]), modes)),
                                sass_issue_ms=issue_ms("K1 recur mode", modes))
                if label == "376x452" and dtype == torch.float32 and sname == "converged":
                    pms = time_ms(lambda: cosine_gq.cos_mode_sums_torch(p.cheb, *sites), 3)
                    clocks = smi("name,power.limit,clocks.sm,clocks.max.sm")
                    ms = {k: v[0] for k, v in k1_ms.items()}
                    record["K1"].update(ms=ms["converged", "recur"],
                                        ms_min=k1_ms["converged", "recur"][1], plain_ms=pms,
                                        ms_v1=ms["converged", "v1"],
                                        ms_init=ms["init", "recur"],
                                        ms_v1_init=ms["init", "v1"], library_ms=None)
                    log(f"  K1 376x452 f32 on {clocks} (name, power limit, SM clock, max SM "
                        f"clock), (median, min) of {TIMING[0]} windows of {TIMING[1]} calls: "
                        f"recur {k1_ms['converged', 'recur']} ms converged, "
                        f"{k1_ms['init', 'recur']} ms from init; v1 "
                        f"{k1_ms['converged', 'v1']} ms converged, "
                        f"{k1_ms['init', 'v1']} ms from init; plain {pms:.4f} ms; "
                        f"{fmt_bound(record['K1'])}")
                if label == "376x452" and dtype == torch.float64 and sname == "converged":
                    log(f"  K1 376x452 f64: kernel {time_ms(lambda: k1_fn(p.cheb, *sites), 3):.4f}"
                        f" ms, plain "
                        f"{time_ms(lambda: cosine_gq.cos_mode_sums_torch(p.cheb, *sites), 1):.4f} ms")

    g = torch.Generator().manual_seed(1)

    def rand(lo, hi, like):
        return (lo + (hi - lo) * torch.rand(like.shape, generator=g, dtype=torch.float64)
                ).to(dev)

    sign = torch.where(rand(0, 1, st64.rou) < 0.5, -1.0, 1.0)
    k2_probes = {
        "init": st64,  # rho = 0, sigma at its init width
        "warm": conv64._replace(rou=rand(-0.9, 0.9, st64.rou)),
        # the corr_tor corner (1 - 1e-5) that converged runs reach: 1/(1-rho^2) ~ 5e4
        "clamp": st64._replace(rou=0.99999 * sign, sigmau=rand(0.01, 3, st64.sigmau),
                               sigmav=rand(0.01, 3, st64.sigmav)),
    }

    def state_stacks(st, dtype):
        s = cast(st, dtype)
        return torch.stack([s.muu, s.muv]), torch.stack([s.sigmau, s.sigmav]), s.rou

    def k2_args(st, dtype, rule=k1):
        mu, sg, rou = state_stacks(st, dtype)
        T = torch.tensor(0.0, dtype=dtype, device=dev)
        alpha = torch.softmax(cast(st, dtype).w, 0)
        return (mu, sg, rou, alpha, T, rule, cfg32.lambdas, cfg32.epsn, EDGE)

    def worst_rel(xs, gold):
        return max(float((x.double() - y).abs().max() / y.abs().max()) for x, y in zip(xs, gold))

    def instance(rule, generic, specialised):
        """A rule size and the instance that runs it."""
        return f"{rule} {'generic' if generic or rule not in specialised else 'specialised'}"

    # beside the main path's instance: the generic one at the same rule, the
    # super presets' rule and a rule of the generic instance
    k2_plain = edge_reduced_gq.edge_reduced_grads_torch
    for dtype in (torch.float64, torch.float32):
        for sname, st in k2_probes.items():
            args = k2_args(st, dtype)
            got = k2_fn(*args)[:6]
            want = k2_plain(*args)[:6]
            a, r, ok = compare(got, want, dtype)
            shape = tuple(args[2].shape)
            if sname == "clamp" and dtype == torch.float64:
                # at the clamp every evaluation loses ~eps/(1-rho^2) to
                # cancellation (Z1 - p Z2, the c of nearly equal sigmas), so
                # two f64 summation orders differ by far more than 1e-10 and
                # f64 has no golden here: reported, checked in f32 below
                log(f"  K2 {shape} float64 clamp (not checked): max abs err {a:.3e}, "
                    f"rel {r:.3e}")
            elif sname == "clamp":
                # each f32 version is held to the f64 golden on the same
                # inputs: kernel error <= 2 x plain error
                gold = k2_plain(*(x.double() if isinstance(x, torch.Tensor) else x
                                  for x in args))[:6]
                ek, ep = worst_rel(got, gold), worst_rel(want, gold)
                require(ek <= 2.0 * ep, f"K2 {shape} float32 clamp: error vs f64 golden "
                                        f"kernel {ek:.3e} <= 2 x plain {ep:.3e} "
                                        f"(kernel vs plain max abs {a:.3e})")
            else:
                require(ok, f"K2 {shape} {str(dtype)[6:]} {sname} "
                            f"K1={instance(k1, False, edge_reduced_gq.SPECIALISED)}: "
                            f"max abs err {a:.3e}, rel {r:.3e}")
            if sname != "warm":
                continue
            for rule, generic in ((k1, True), (25, False), (13, False)):
                oargs = args[:5] + (rule,) + args[6:]
                a2, r2, ok2 = compare(k2_fn(*oargs, generic=generic)[:6], k2_plain(*oargs)[:6],
                                      dtype)
                require(ok2, f"K2 {shape} {str(dtype)[6:]} warm K1="
                             f"{instance(rule, generic, edge_reduced_gq.SPECIALISED)}: max abs "
                             f"err {a2:.3e}, rel {r2:.3e}")
            ms = kernel_ms(lambda: k2_fn(*args))
            gms = kernel_ms(lambda: k2_fn(*args, generic=True))
            b2b = time_ms(lambda: k2_fn(*args), TIMING[1])
            pms = time_ms(lambda: k2_plain(*args), 5)
            log(f"  K2 {str(dtype)[6:]} (median, min) ms: kernel {ms}, generic instance {gms}; "
                f"{TIMING[1]} calls back to back from the host {b2b:.4f} ms a call; plain "
                f"{pms:.4f} ms")
            if dtype == torch.float32:
                n_el = args[2].numel()
                record["K2"] = dict(max_abs_err=a, ms=ms[0], ms_min=ms[1], ms_generic=gms[0],
                                    ms_generic_min=gms[1], ms_back_to_back=b2b, plain_ms=pms,
                                    library_ms=None,
                                    **bound(roofline.k2_work(shape, k1)),
                                    sass_issue_ms=issue_ms("K2 point", n_el * k1))
                log(f"  K2 {fmt_bound(record['K2'])} ({record['K2']['bound_terms_ms']}); "
                    "SASS issue "
                    f"bound {record['K2']['sass_issue_ms']:.4f} ms")

    # ---- 4. one full sweep, three ways
    log("phase sweep")
    gold = pg.make_sweep(dataclasses.replace(cfg64, node_kernel="torch", edge_kernel="torch"),
                         (H, W))
    plain32 = pg.make_sweep(dataclasses.replace(cfg32, node_kernel="torch",
                                              edge_kernel="torch"), (H, W))
    kern32 = pg.make_sweep(dataclasses.replace(cfg32, node_kernel="cuda", edge_kernel="cuda"),
                           (H, W))
    three_way_sweep("", gold, plain32, kern32, prob, (("init", st64), ("converged", conv64)),
                    cast)
    rb = dict(sweep_order="redblack")
    three_way_sweep("tpu_fast redblack ",
                    pg.make_sweep(dataclasses.replace(cfg64, node_kernel="torch",
                                                      edge_kernel="torch", **rb), (H, W)),
                    pg.make_sweep(dataclasses.replace(cfg32, node_kernel="torch",
                                                      edge_kernel="torch", **rb), (H, W)),
                    pg.make_sweep(dataclasses.replace(cfg32, node_kernel="cuda",
                                                      edge_kernel="cuda", **rb), (H, W)),
                    prob, (("init", st64), ("converged", conv64)), cast)

    # ---- 5. the slice, through the user entry point
    log("phase solve")
    del crop, prob, gold, plain32, kern32
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    for f in (k1_fn, k2_fn, *ufns.values(), *qfns.values()):
        f.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t = time.time()
    res = solve(cfg32, I1, I2, gt_flow=gt, flow_range=fr, device=dev, verbose=True)
    torch.cuda.synchronize()
    wall = time.time() - t
    launches = {"K1": k1_fn.launches, "K2": k2_fn.launches,
                **{k: f.launches for k, f in ufns.items()},
                **{k: f.launches for k, f in qfns.items()}}
    peak = torch.cuda.max_memory_allocated()
    require(res.iters == 900, f"solve ran {res.iters} sweeps (900 asked)")
    require(bool(np.isfinite(res.Energy[:res.iters]).all()), "energy finite over every sweep")
    a1, a900 = res.AEPE[0], res.AEPE[res.iters - 1]
    require(bool(a900 <= 0.5 * a1), f"AEPE {a1:.4f} at it=1 -> {a900:.4f} at it=900 "
                                    "(at most half)")
    require(launches == {"K1": res.iters, "K2": res.iters, "K8": res.iters, "K9": res.iters,
                         "K9 v1": 0, "K10": 0, "K11": 0, "K12": 0, "K13": 0, "K14": 0, "K15": 0,
                         "K16": 0},
            f"launch counters {launches} equal the sweep count {res.iters} (K9 v2's tails run "
            f"in K8 v2's launches; no K9 v1 or K10-K16 launch)")
    log(f"  solve wall {wall:.3f} s incl. build_cos_data and 4 readouts; "
        f"peak device memory {peak / 2**30:.3f} GiB; AEPE trace "
        f"{[round(float(x), 4) for x in res.AEPE[[0, 299, 599, 899]]]}")
    res2 = solve(cfg32, I1, I2, gt_flow=gt, flow_range=fr, device=dev)
    require(np.array_equal(res.AEPE, res2.AEPE, equal_nan=True),
            f"a second 900-sweep solve gives the same AEPE trace, bit for bit "
            f"({[float(x) for x in res2.AEPE[[0, 299, 599, 899]]]}); energy trace equal "
            f"{np.array_equal(res.Energy, res2.Energy, equal_nan=True)}")

    p32 = pg.make_problem(cfg32, I1, I2, fr, dev)
    seg = pg.make_segment_runner(dataclasses.replace(cfg32, tor=0.0), (H, W))
    st32 = cast(st64, torch.float32)
    for sname, st in (("from init", st32),
                      ("converged", st32._replace(sigmau=torch.full_like(st32.sigmau, 0.05),
                                                  sigmav=torch.full_like(st32.sigmav, 0.05)))):
        st, *_ = seg(p32, st, 10)
        ms = time_ms(lambda: seg(p32, st, 300), 1) / 300
        require(seg.route == "graph", f"segment {sname}: the runner's route {seg.route!r} is "
                                      "'graph'")
        log(f"  segment {sname}: {ms:.4f} ms/sweep (300-sweep segment, CUDA events)")
        record.setdefault("segment_ms_per_sweep", {})[sname] = ms
    # where a sweep's time goes between host and card: 50 sweeps back to back
    # without the segment's per-sweep flag read, the host's time to enqueue
    # them against the time until the card has run them
    sweep32 = pg.make_sweep(cfg32, (H, W))
    st = seg(p32, st32, 10)[0]
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(50):
        st, _ = sweep32(p32, st)
    t_host = time.perf_counter() - t
    torch.cuda.synchronize()
    t_all = time.perf_counter() - t
    log(f"  50 sweeps from init without the flag read: host enqueue {t_host / 50 * 1e3:.4f} "
        f"ms/sweep, until the card is done {t_all / 50 * 1e3:.4f} ms/sweep")

    # ---- 6. K3 against its plain version
    log("phase kernels K3")
    k3_fn = edge_gq.edge_gq_cuda
    fm32 = GQMAPConfig.full_mixture(quad_chunk=27, its=900, eval_every=300)
    fm64 = dataclasses.replace(fm32, dtype="float64")
    g3 = torch.Generator().manual_seed(3)

    def rand3(lo, hi, like):
        return (lo + (hi - lo) * torch.rand(like.shape, generator=g3, dtype=torch.float64)
                ).to(dev)

    k3_probes = {
        "init": st64,
        # sigma drawn per site: with equal sigmas at both endpoints Sm is zero
        # by a reflection symmetry of the rule, and a check relative to its
        # largest magnitude would compare rounding noise
        "warm": st64._replace(rou=rand3(-0.9, 0.9, st64.rou),
                              sigmau=rand3(0.01, 3, st64.sigmau),
                              sigmav=rand3(0.01, 3, st64.sigmav)),
        "clamp": k2_probes["clamp"],
    }

    def k3_args(st, dtype, K=fm32.K):
        mu, sg, rou = state_stacks(st, dtype)
        return (mu, sg, *edge_reduced_gq.neighbour_stacks(mu, sg), rou, K, fm32.lambdas,
                fm32.epsn)

    k3_plain = edge_gq.edge_gq_torch
    for dtype in (torch.float64, torch.float32):
        for sname, st in k3_probes.items():
            args = k3_args(st, dtype)
            got = k3_fn(*args)
            want = k3_plain(*args)
            a, r, ok = compare(got, want, dtype)
            shape = tuple(args[2].shape)
            require(ok, f"K3 {shape} K={instance(fm32.K, False, edge_gq.SPECIALISED)} {str(dtype)[6:]} "
                        f"{sname}: max abs err {a:.3e}, rel {r:.3e}")
            if sname == "clamp" and dtype == torch.float32:
                # the raw sums are not ill-conditioned at the clamp (finalize
                # is), so both errors sit at rounding level: the floor is
                # 1e-6 of the largest magnitude, as in tests/test_torch_cuda.py
                gold = k3_plain(*(x.double() if isinstance(x, torch.Tensor) else x
                                  for x in args))
                ek, ep = worst_rel(got, gold), worst_rel(want, gold)
                require(ek <= 2.0 * ep + 1e-6, f"K3 {shape} float32 clamp: error vs f64 golden "
                                               f"kernel {ek:.3e} <= 2 x plain {ep:.3e} + 1e-6")
            if sname != "warm":
                continue
            for K, generic in ((fm32.K, True), (11, False), (5, False)):
                oargs = args[:5] + (K,) + args[6:]
                a2, r2, ok2 = compare(k3_fn(*oargs, generic=generic), k3_plain(*oargs), dtype)
                require(ok2, f"K3 {shape} {str(dtype)[6:]} warm K="
                             f"{instance(K, generic, edge_gq.SPECIALISED)}: max abs err "
                             f"{a2:.3e}, rel {r2:.3e}")
            ms = kernel_ms(lambda: k3_fn(*args))
            gms = kernel_ms(lambda: k3_fn(*args, generic=True))
            b2b = time_ms(lambda: k3_fn(*args), TIMING[1])
            pms = time_ms(lambda: k3_plain(*args), 3)
            log(f"  K3 {str(dtype)[6:]} (median, min) ms: kernel {ms}, generic instance {gms}; "
                f"{TIMING[1]} calls back to back from the host {b2b:.4f} ms a call; plain "
                f"{pms:.4f} ms")
            if dtype == torch.float32:
                n_el = args[2].numel()
                points = fm32.K ** 2
                record["K3"] = dict(max_abs_err=a, ms=ms[0], ms_min=ms[1], ms_generic=gms[0],
                                    ms_generic_min=gms[1], ms_back_to_back=b2b, plain_ms=pms,
                                    library_ms=None,
                                    **bound(roofline.k3_work(shape, fm32.K)),
                                    sass_issue_ms=issue_ms("K3 point", n_el * points))
                log(f"  K3 {fmt_bound(record['K3'])} ({record['K3']['bound_terms_ms']}); "
                    "SASS issue "
                    f"bound {record['K3']['sass_issue_ms']:.4f} ms")

    # ---- 6b. K4 against its plain version
    kernels_k4(dev, record, I1, I2, ceil["gather_Mtaps_s"], issue_ms)
    k4_fn = node_gq.node_gq_cuda

    # ---- 6c. K5 against its plain version
    kernels_k5(dev, record, issue_ms, sass)
    k5_fn = cheb_gq.cheb_gq_cuda

    # ---- 6d. K6 and K7 against their plain versions
    kernels_k6_k7(dev, record, I1, I2, issue_ms)
    k6_fn, k7_fn = nearest_gq.nearest_gq_cuda, nearest_gq.nearest_chain_gq_cuda

    # ---- 6e. K10 and K11 against their plain versions
    kernels_k10_k11(dev, record, issue_ms)

    # ---- 6f. K12 against its plain version
    kernels_k12(dev, record, I1, I2, issue_ms)

    # ---- 7. one full_mixture sweep, three ways
    log("phase exact sweep")
    fprob = {torch.float32: pg.make_problem(fm32, I1, I2, fr, dev),
             torch.float64: pg.make_problem(fm64, I1, I2, fr, dev)}
    plain_routes = dict(node_kernel="torch", edge_kernel="torch")
    kernel_routes = dict(node_kernel="cuda", edge_kernel="cuda")
    three_way_sweep("full_mixture ",
                    pg.make_sweep(dataclasses.replace(fm64, **plain_routes), (H, W)),
                    pg.make_sweep(dataclasses.replace(fm32, **plain_routes), (H, W)),
                    pg.make_sweep(dataclasses.replace(fm32, **kernel_routes), (H, W)),
                    fprob, (("init", st64), ("converged", conv64)), cast)

    # ---- 8. the exact slice, through the user entry point
    log("phase exact solve")
    p32 = fprob[torch.float32]
    del fprob
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    for f in (k1_fn, k2_fn, k3_fn, k4_fn, k5_fn, k6_fn, k7_fn, *qfns.values()):
        f.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t = time.time()
    fres = solve(fm32, I1, I2, gt_flow=gt, flow_range=fr, device=dev, verbose=True)
    torch.cuda.synchronize()
    fwall = time.time() - t
    flaunch = {"K1": k1_fn.launches, "K2": k2_fn.launches, "K3": k3_fn.launches,
               "K4": k4_fn.launches, "K5": k5_fn.launches, "K6": k6_fn.launches,
               "K7": k7_fn.launches, **{k: f.launches for k, f in qfns.items()}}
    fpeak = torch.cuda.max_memory_allocated()
    record["peak_GiB"] = {"full_mixture": fpeak / 2**30}
    require(fres.iters == fm32.its, f"solve ran {fres.iters} sweeps ({fm32.its} asked)")
    require(bool(np.isfinite(fres.Energy[:fres.iters]).all()), "energy finite over every sweep")
    a1, an = fres.AEPE[0], fres.AEPE[fres.iters - 1]
    require(bool(an < a1), f"AEPE {a1:.4f} at it=1 -> {an:.4f} at it={fres.iters} (falls)")
    require(flaunch == launch_counts(K3=fres.iters, K4=fres.iters),
            f"launch counters {flaunch}: K3 and K4 equal the sweep count {fres.iters}, K1, K2, "
            "K5, K6 and K7 0")
    log(f"  solve wall {fwall:.3f} s incl. 4 readouts; peak device memory "
        f"{fpeak / 2**30:.3f} GiB; AEPE trace "
        f"{[round(float(x), 4) for x in fres.AEPE[[0, 299, 599, 899]]]}")

    seg = pg.make_segment_runner(dataclasses.replace(fm32, tor=0.0), (H, W))
    st, *_ = seg(p32, cast(st64, torch.float32), 10)
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    seg(p32, st, 300)
    t1.record()
    torch.cuda.synchronize()
    record["exact_segment_ms_per_sweep"] = t0.elapsed_time(t1) / 300
    log(f"  exact segment: {record['exact_segment_ms_per_sweep']:.4f} ms/sweep "
        "(300-sweep segment, CUDA events)")
    del seg  # its graph and pool

    sweep = pg.make_sweep(fm32, (H, W))
    a3 = torch.softmax(st.w, 0).reshape(fm32.L, 1, 1)

    def node_term(fn=k4_fn, cfg=fm32, problem=p32, s=st, a=a3):
        """The node term as the sweep runs it: K4 (or ``fn``) and finalize."""
        raw = fn(problem.I1, problem.I2_tab, s.muu, s.muv, s.sigmau, s.sigmav, s.pn, cfg.K,
                 cfg.lambdad, cfg.epsn, patch=cfg.patch)
        return finalize(raw, a, s.sigmau, s.sigmav, s.pn, s.temperature, NODE)

    k3_state = k3_args(st, torch.float32)
    split = dict(sweep=time_ms(lambda: sweep(p32, st), 10), node=time_ms(node_term, 10),
                 K3=kernel_ms(lambda: k3_fn(*k3_state))[0])
    split["rest"] = split["sweep"] - split["node"] - split["K3"]
    split["node_plain"] = time_ms(lambda: node_term(functools.partial(
        node_gq.node_gq_torch, quad_chunk=fm32.quad_chunk)), 5)
    record["exact_sweep_split_ms"] = split
    log("  one exact sweep (CUDA events): " + ", ".join(f"{k} {v:.4f} ms"
                                                       for k, v in split.items()))

    # ---- 9. resume on the card
    log("phase resume")
    c300, c600 = (dataclasses.replace(fm32, its=n) for n in (300, 600))
    with tempfile.TemporaryDirectory(dir=build.BUILD_DIR) as tmp:
        ck = os.path.join(tmp, "ck.npz")
        solve(c300, I1, I2, gt_flow=gt, flow_range=fr, device=dev, checkpoint_path=ck)
        resumed = solve(c600, I1, I2, gt_flow=gt, flow_range=fr, device=dev,
                        checkpoint_path=ck, resume=True)
    full = solve(c600, I1, I2, gt_flow=gt, flow_range=fr, device=dev)
    diff = max(float((getattr(resumed.state, f).double()
                      - getattr(full.state, f).double()).abs().max())
               for f in resumed.state._fields)
    same_traces = all(np.array_equal(getattr(resumed, n), getattr(full, n), equal_nan=True)
                      for n in ("AEPE", "Energy", "logP"))
    require(resumed.iters == full.iters == 600 and diff == 0.0 and same_traces
            and resumed.best_aepe == full.best_aepe,
            f"resumed 300 -> 600 equals an unbroken 600-sweep solve (max state diff {diff:.3e},"
            f" traces equal {same_traces}, best AEPE {resumed.best_aepe:.6f} vs "
            f"{full.best_aepe:.6f})")

    # ---- 10. the kernels on the super lattice (patch = 4: 94x113 sites)
    log("phase kernels super")
    fs32 = GQMAPConfig.tpu_fast_super(its=900, eval_every=300)
    fs64 = dataclasses.replace(fs32, dtype="float64")
    se32 = GQMAPConfig.super_entropy(its=900, eval_every=300)
    se64 = dataclasses.replace(se32, dtype="float64")
    k1s = 2 * fs32.K + 3
    t = time.time()
    sprob = {torch.float32: pg.make_problem(fs32, I1, I2, fr, dev),
             torch.float64: pg.make_problem(fs64, I1, I2, fr, dev)}
    torch.cuda.synchronize()
    log(f"make_problem tpu_fast_super f32 + f64 (coefficient fields "
        f"{tuple(sprob[torch.float32].cheb.coeffs.shape)}): {time.time() - t:.3f} s")
    sst64 = pg.init_state(fs64, fr, (H, W), seed=0, device=dev)
    sconv64 = sst64._replace(sigmau=torch.full_like(sst64.sigmau, 0.05),
                             sigmav=torch.full_like(sst64.sigmav, 0.05))
    for dtype in (torch.float64, torch.float32):
        p = sprob[dtype]
        A, B = p.cheb.coeffs.shape[:2]
        for sname, st in (("init", sst64), ("converged", sconv64)):
            s = cast(st, dtype)
            sites = (s.muu, s.muv, s.sigmau, s.sigmav, s.pn)
            want = cosine_gq.cos_mode_sums_torch(p.cheb, *sites)
            for variant in cosine_gq.VARIANTS:
                cnt = torch.zeros(3, dtype=torch.int64, device=dev)
                got = k1_fn(p.cheb, *sites, variant=variant, counters=cnt)
                a, r, ok = compare(got, want, dtype)
                n_recur, n_exp, modes = cnt.tolist()
                require(ok, f"K1 super {tuple(sites[0].shape)} A={A} {str(dtype)[6:]} {sname} "
                            f"{variant}: max abs err {a:.3e}, rel {r:.3e}; counters: {n_recur} "
                            f"warps recur, {n_exp} exp, {modes} modes of "
                            f"{A * B * sites[0].numel()}")
                if sname == "converged" and variant == "recur":
                    require(n_exp == 0 and n_recur > 0,
                            f"K1 super {str(dtype)[6:]} converged: every warp ran the recur "
                            f"body ({n_recur} recur, {n_exp} exp)")
                if dtype == torch.float32 and sname == "converged" and variant == "recur":
                    record["K1"]["super"] = dict(
                        shape=[A, B] + list(sites[0].shape), max_abs_err=a,
                        **bound(roofline.k1_work(p.cheb.coeffs.shape, len(sites[0]), modes)),
                        sass_issue_ms=issue_ms("K1 recur mode", modes))
            if dtype == torch.float32 and sname == "converged":
                sup = record["K1"]["super"]
                ms = kernel_ms(lambda: k1_fn(p.cheb, *sites))
                s0 = cast(sst64, dtype)
                init_sites = (s0.muu, s0.muv, s0.sigmau, s0.sigmav, s0.pn)
                sup.update(ms=ms[0], ms_min=ms[1],
                           ms_v1=kernel_ms(lambda: k1_fn(p.cheb, *sites, variant="v1"))[0],
                           ms_init=kernel_ms(lambda: k1_fn(p.cheb, *init_sites))[0],
                           plain_ms=time_ms(lambda: cosine_gq.cos_mode_sums_torch(p.cheb,
                                                                                  *sites), 3),
                           library_ms=None)
                log(f"  K1 super f32 on {smi('name,power.limit,clocks.sm')}: recur {ms} ms "
                    f"converged (median, min), {sup['ms_init']:.4f} ms from init; v1 "
                    f"{sup['ms_v1']:.4f} ms; plain {sup['plain_ms']:.4f} ms; "
                    f"{fmt_bound(sup)}")

    g4 = torch.Generator().manual_seed(4)

    def rand4(lo, hi, like):
        return (lo + (hi - lo) * torch.rand(like.shape, generator=g4, dtype=torch.float64)
                ).to(dev)

    sign4 = torch.where(rand4(0, 1, sst64.rou) < 0.5, -1.0, 1.0)
    super_probes = {
        "init": sst64,
        "warm": sst64._replace(rou=rand4(-0.9, 0.9, sst64.rou),
                               sigmau=rand4(0.01, 3, sst64.sigmau),
                               sigmav=rand4(0.01, 3, sst64.sigmav)),
        "clamp": sst64._replace(rou=0.99999 * sign4, sigmau=rand4(0.01, 3, sst64.sigmau),
                                sigmav=rand4(0.01, 3, sst64.sigmav)),
    }

    def super_k2_args(st, dtype):
        mu, sg, rou = state_stacks(st, dtype)
        T = torch.tensor(fs32.temperature, dtype=dtype, device=dev)
        return (mu, sg, rou, torch.softmax(cast(st, dtype).w, 0), T, k1s, fs32.lambdas,
                fs32.epsn, EDGE)

    def super_k3_args(st, dtype):
        mu, sg, rou = state_stacks(st, dtype)
        return (mu, sg, *edge_reduced_gq.neighbour_stacks(mu, sg), rou, se32.K, se32.lambdas,
                se32.epsn)

    # K2 at K1 = 25 (tpu_fast_super) and K3 at K = 11 (super_entropy); the
    # clamp rules of phases 3 and 6
    for name, fn, plain, args_of, floor in (
            ("K2", k2_fn, edge_reduced_gq.edge_reduced_grads_torch, super_k2_args, 0.0),
            ("K3", edge_gq.edge_gq_cuda, edge_gq.edge_gq_torch, super_k3_args, 1e-6)):
        rule = f"K1={k1s}" if name == "K2" else f"K={se32.K}"
        for dtype in (torch.float64, torch.float32):
            for sname, st in super_probes.items():
                args = args_of(st, dtype)
                got, want = fn(*args)[:6], plain(*args)[:6]
                a, r, ok = compare(got, want, dtype)
                shape = tuple(args[2].shape) if name == "K2" else tuple(args[4].shape)
                if sname == "clamp" and dtype == torch.float64 and name == "K2":
                    log(f"  K2 super {shape} float64 clamp (not checked): max abs err {a:.3e}, "
                        f"rel {r:.3e}")
                    continue
                if sname == "clamp" and dtype == torch.float32:
                    gold = plain(*(x.double() if isinstance(x, torch.Tensor) else x
                                   for x in args))[:6]
                    ek, ep = worst_rel(got, gold), worst_rel(want, gold)
                    require(ek <= 2.0 * ep + floor,
                            f"{name} super {shape} {rule} float32 clamp: error vs f64 golden "
                            f"kernel {ek:.3e} <= 2 x plain {ep:.3e} + {floor:g}")
                    if name == "K2":
                        continue
                require(ok, f"{name} super {shape} {rule} {str(dtype)[6:]} {sname}: max abs err "
                            f"{a:.3e}, rel {r:.3e}")
                if sname != "warm" or dtype != torch.float32:
                    continue
                ms = kernel_ms(lambda: fn(*args))
                work = (roofline.k2_work(shape, k1s) if name == "K2"
                        else roofline.k3_work(shape, se32.K))
                record[name]["super"] = dict(
                    shape=list(shape), rule=rule, max_abs_err=a, ms=ms[0], ms_min=ms[1],
                    plain_ms=time_ms(lambda: plain(*args), 5), library_ms=None,
                    **bound(work))
                sup = record[name]["super"]
                log(f"  {name} super {shape} {rule} f32 (median, min) {ms} ms; plain "
                    f"{sup['plain_ms']:.4f} ms; {fmt_bound(sup)} ({sup['bound_terms_ms']})")

    # ---- 11. one full sweep of each new path, three ways
    log("phase super sweeps")
    eprob = {torch.float32: pg.make_problem(se32, I1, I2, fr, dev),
             torch.float64: pg.make_problem(se64, I1, I2, fr, dev)}
    sstates = (("init", sst64), ("converged", sconv64))
    three_way_sweep("tpu_fast_super ",
                    pg.make_sweep(dataclasses.replace(fs64, node_kernel="torch",
                                                      edge_kernel="torch"), (H, W)),
                    pg.make_sweep(dataclasses.replace(fs32, node_kernel="torch",
                                                      edge_kernel="torch"), (H, W)),
                    pg.make_sweep(dataclasses.replace(fs32, node_kernel="cuda",
                                                      edge_kernel="cuda"), (H, W)),
                    sprob, sstates, cast)
    # the f64 golden takes the 121 node points in three steps (its f64
    # samples at once would need ~2x the f32 arms' memory)
    three_way_sweep("super_entropy ",
                    pg.make_sweep(dataclasses.replace(se64, quad_chunk=41, **plain_routes),
                                  (H, W)),
                    pg.make_sweep(dataclasses.replace(se32, **plain_routes), (H, W)),
                    pg.make_sweep(dataclasses.replace(se32, **kernel_routes), (H, W)),
                    eprob, sstates, cast)
    del sprob, eprob

    # ---- 12. the super presets through the user entry point
    log("phase super solves")
    kfns = {"K1": k1_fn, "K2": k2_fn, "K3": edge_gq.edge_gq_cuda, "K4": k4_fn, "K5": k5_fn,
            "K6": k6_fn, "K7": k7_fn, **qfns}
    by_path = {"tpu_fast": launches, "full_mixture": flaunch}

    def counted_solve(path, cfg, want, **kw):
        """A solve with every launch counter set to 0 just before it and read
        just after: finite energy and the counts ``want`` x the sweeps."""
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        for f in kfns.values():
            f.launches = 0
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t = time.time()
        res = solve(cfg, I1, I2, gt_flow=gt, flow_range=fr, device=dev, **kw)
        torch.cuda.synchronize()
        wall = time.time() - t
        counts = {k: f.launches for k, f in kfns.items()}
        peak = torch.cuda.max_memory_allocated()
        by_path[path] = counts
        n = res.iters
        require(n == cfg.its, f"{path} solve ran {n} sweeps ({cfg.its} asked)")
        require(bool(np.isfinite(res.Energy[:n]).all()), f"{path}: energy finite over every sweep")
        require(counts == {k: w * n for k, w in want.items()},
                f"{path}: launch counters {counts} equal {want} x the sweep count {n}")
        evals = [i for i in range(n) if np.isfinite(res.AEPE[i])]
        log(f"  {path} solve wall {wall:.3f} s; peak device memory {peak / 2**30:.3f} GiB, "
            f"{(peak - base) / 2**30:.3f} GiB above the {base / 2**30:.3f} GiB held before it; "
            f"AEPE trace {[float(res.AEPE[i]) for i in evals]}")
        record["peak_GiB"][path] = peak / 2**30
        record.setdefault("solve_GiB_above_held", {})[path] = (peak - base) / 2**30
        record.setdefault("solve_wall_s", {})[path] = wall
        return res

    def nearest_turns(fn):
        """``fn()`` with K6 and K7 in turns: "v2" (the default), "v1" (made
        the default for the call) and "v2" again; the three results."""
        out = []
        for variant in ("v2", "v1", "v2"):
            default, nearest_gq._DEFAULT_VARIANT = nearest_gq._DEFAULT_VARIANT, variant
            try:
                out.append(fn())
            finally:
                nearest_gq._DEFAULT_VARIANT = default
        return out

    def solve_turns(path, cfg, want, **kw):
        """``counted_solve`` in turns (v2, v1, v2): the same AEPE and energy
        traces, bit for bit (v2's sums are v1's); each turn's wall. Returns
        the first turn's result."""
        turns = nearest_turns(lambda: (counted_solve(path, cfg, want, **kw),
                                       record["solve_wall_s"][path]))
        res = turns[0][0]
        walls = record.setdefault("solve_wall_s_turns", {})[path] = dict(
            zip(("v2", "v1", "v2_again"), (w for _, w in turns)))
        require(all(np.array_equal(res.AEPE, r.AEPE, equal_nan=True)
                    and np.array_equal(res.Energy, r.Energy, equal_nan=True) for r, _ in turns),
                f"{path}: the solves with K6/K7 v2, v1 and v2 again give the same AEPE and energy "
                f"traces, bit for bit; walls {walls} s")
        return res

    def segment_turns(path, cfg, problem, state):
        """``segment_ms`` in turns (v2, v1, v2); v2, the default, must be no
        slower than v1 there. Returns v2's ms a sweep."""
        ms = nearest_turns(lambda: segment_ms(path, cfg, problem, state))
        turns = record.setdefault("segment_ms_turns", {})[path] = dict(
            zip(("v2", "v1", "v2_again"), ms))
        record["segment_ms_per_sweep_by_path"][path] = ms[0]
        require(min(ms[0], ms[2]) <= ms[1],
                f"{path}: the graph segment with K6/K7 v2 no slower than with v1 ({turns} ms a "
                "sweep)")
        return ms[0]

    def aepe_falls(path, res):
        a1, an = res.AEPE[0], res.AEPE[res.iters - 1]
        require(bool(an < a1), f"{path}: AEPE {a1:.4f} at it=1 -> {an:.4f} at it={res.iters} "
                               "(falls)")
        return res

    def segment_ms(path, cfg, problem, state):
        """ms a sweep of a 30-sweep segment from ``state`` (CUDA events)."""
        # (its raised: a solve's final state is past its own its)
        seg = pg.make_segment_runner(dataclasses.replace(cfg, tor=0.0, its=cfg.its + 40), (H, W))
        st, *_ = seg(problem, state, 5)
        t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0.record()
        done = seg(problem, st, 30)[1]
        t1.record()
        torch.cuda.synchronize()
        require(done == 30, f"{path}: the timed segment ran {done} sweeps (30 asked)")
        ms = record.setdefault("segment_ms_per_sweep_by_path", {})[path] = t0.elapsed_time(t1) / 30
        log(f"  {path}: {ms:.4f} ms a sweep (30-sweep segment, CUDA events)")
        return ms

    sres = aepe_falls("tpu_fast_super", counted_solve("tpu_fast_super", fs32,
                                                      launch_counts(K1=1, K2=1),
                                                      verbose=True))
    sres2 = solve(fs32, I1, I2, gt_flow=gt, flow_range=fr, device=dev)
    require(np.array_equal(sres.AEPE, sres2.AEPE, equal_nan=True)
            and np.array_equal(sres.Energy, sres2.Energy, equal_nan=True),
            "a second tpu_fast_super solve gives the same AEPE and energy traces, bit for bit")
    aepe_falls("super_entropy", counted_solve("super_entropy", se32,
                                              launch_counts(K3=1, K4=1),
                                              verbose=True))

    p32 = pg.make_problem(se32, I1, I2, fr, dev)
    ust = cast(sst64, torch.float32)
    usweep = pg.make_sweep(se32, (H, W))
    ua3 = torch.softmax(ust.w, 0).reshape(se32.L, 1, 1)
    k3_state = super_k3_args(sst64, torch.float32)
    split = dict(sweep=time_ms(lambda: usweep(p32, ust), 10),
                 node=time_ms(lambda: node_term(cfg=se32, problem=p32, s=ust, a=ua3), 10),
                 K3=kernel_ms(lambda: edge_gq.edge_gq_cuda(*k3_state))[0])
    split["rest"] = split["sweep"] - split["node"] - split["K3"]
    split["node_plain"] = time_ms(lambda: node_term(functools.partial(
        node_gq.node_gq_torch, quad_chunk=se32.quad_chunk), se32, p32, ust, ua3), 5)
    record["super_entropy_sweep_split_ms"] = split
    log("  one super_entropy sweep (CUDA events): " + ", ".join(f"{k} {v:.4f} ms"
                                                               for k, v in split.items()))
    del p32
    sp32 = pg.make_problem(fs32, I1, I2, fr, dev)
    sseg = pg.make_segment_runner(dataclasses.replace(fs32, tor=0.0), (H, W))
    st, *_ = sseg(sp32, ust, 10)
    record["tpu_fast_super_segment_ms_per_sweep"] = time_ms(lambda: sseg(sp32, st, 300), 1) / 300
    log(f"  tpu_fast_super segment: {record['tpu_fast_super_segment_ms_per_sweep']:.4f} "
        "ms/sweep (300-sweep segment, CUDA events)")
    del sp32, sseg

    # ---- 13. the red-black order through the user entry point
    log("phase redblack solve")
    rb32 = dataclasses.replace(cfg32, its=300, **rb)
    aepe_falls("tpu_fast redblack", counted_solve("tpu_fast redblack", rb32,
                                                  launch_counts(K1=2, K2=2)))
    p32 = pg.make_problem(cfg32, I1, I2, fr, dev)
    rseg = pg.make_segment_runner(dataclasses.replace(rb32, tor=0.0), (H, W))
    st, *_ = rseg(p32, st32, 10)
    record["redblack_segment_ms_per_sweep"] = time_ms(lambda: rseg(p32, st, 100), 1) / 100
    log(f"  tpu_fast redblack segment: {record['redblack_segment_ms_per_sweep']:.4f} ms/sweep "
        "(100-sweep segment, CUDA events)")
    del p32, rseg

    # ---- 14. K3 on the legacy presets' L = 1 edge lattice, K = 9 and K = 17
    log("phase legacy kernels")
    v2_32 = GQMAPConfig.legacy_v2(its=300, eval_every=300)
    bm32 = GQMAPConfig.blockmatch_v2(its=300, eval_every=300)
    lst64 = pg.init_state(dataclasses.replace(v2_32, dtype="float64"), fr, (H, W), seed=0,
                          device=dev)
    probes = l1_probes(lst64, torch.Generator().manual_seed(5))
    # K = 9 (legacy_v2, legacy_v3), K = 17 (blockmatch_v2)
    record["K3"]["legacy"] = {f"K={c.K}": k3_on_l1("legacy", c, probes)
                              for c in (v2_32, bm32)}

    # ---- 15. K1 on the window-meaned coefficient field (window_rg = 2)
    log("phase windowed K1")
    wf32 = GQMAPConfig.tpu_fast(window_rg=2, its=300, eval_every=300)
    t = time.time()
    wprob = {dt: pg.make_problem(dataclasses.replace(wf32, dtype=str(dt)[6:]), I1, I2, fr, dev)
             for dt in (torch.float32, torch.float64)}
    torch.cuda.synchronize()
    log(f"make_problem tpu_fast(window_rg=2) f32 + f64: {time.time() - t:.3f} s")
    for dtype in (torch.float64, torch.float32):
        p = wprob[dtype]
        for sname, st in (("init", st64), ("converged", conv64)):
            s = cast(st, dtype)
            sites = (s.muu, s.muv, s.sigmau, s.sigmav, s.pn)
            want = cosine_gq.cos_mode_sums_torch(p.cheb, *sites)
            cnt = torch.zeros(3, dtype=torch.int64, device=dev)
            got = k1_fn(p.cheb, *sites, counters=cnt)
            a, r, ok = compare(got, want, dtype)
            n_recur, n_exp, modes = cnt.tolist()
            require(ok, f"K1 window_rg=2 {str(dtype)[6:]} {sname}: max abs err {a:.3e}, rel "
                        f"{r:.3e}; counters: {n_recur} warps recur, {n_exp} exp, {modes} modes")
            if dtype == torch.float32 and sname == "converged":
                ms = kernel_ms(lambda: k1_fn(p.cheb, *sites))
                rec = record["K1"]["windowed"] = dict(
                    shape=list(p.cheb.coeffs.shape[:2]) + list(sites[0].shape), max_abs_err=a,
                    ms=ms[0], ms_min=ms[1], library_ms=None,
                    plain_ms=time_ms(lambda: cosine_gq.cos_mode_sums_torch(p.cheb, *sites), 3),
                    **bound(roofline.k1_work(p.cheb.coeffs.shape, len(sites[0]), modes)))
                log(f"  K1 window_rg=2 f32 converged (median, min) {ms} ms; plain "
                    f"{rec['plain_ms']:.4f} ms; {fmt_bound(rec)}")
    wp32 = wprob[torch.float32]  # timed with phase 16's solve
    del wprob

    # ---- 16. the legacy presets through the user entry points
    log("phase legacy solves")
    # the nearest lookups through K6 (windowed on legacy_v2), legacy_v3's chain through K7
    # (K6 and K7 in turns: v2, the default, then v1, then v2 again)
    k6_k3 = launch_counts(K3=1, K6=1)
    k7_k3 = launch_counts(K3=1, K7=1)
    v2res = aepe_falls("legacy_v2", solve_turns("legacy_v2", v2_32, k6_k3, verbose=True))
    v3_32 = GQMAPConfig.legacy_v3(its=300, eval_every=300)
    v3res = aepe_falls("legacy_v3", solve_turns("legacy_v3", v3_32, k7_k3, verbose=True))
    segment_turns("legacy_v3", v3_32, pg.make_problem(v3_32, I1, I2, fr, dev), v3res.state)
    t = time.time()
    bm_flow = block_matching_init(I1, I2, device=dev)
    log(f"  block_matching_init 376x452: {time.time() - t:.3f} s; interior flow (median u, v) "
        f"{np.median(bm_flow[8:-8, 8:-8], axis=(0, 1)).tolist()}")
    require(bool((bm_flow[8:-8, 8:-8] == [1.0, 0.0]).mean() > 0.99),
            "block_matching_init finds the pair's shift (u = 1, v = 0) at > 99% of the interior")
    # from the block-matching flow, which is right at it = 1 on this pair, the
    # preset's wide sigma init (the flow range's width, kept as the reference
    # keeps it) moves the means off it, in the JAX engine as in the port
    # (ROADMAP Queue 3, P4; tests/test_torch_legacy.py): the AEPE falls from
    # a random init, and from the block-matching init stays below that
    rand = aepe_falls("blockmatch_v2", solve_turns("blockmatch_v2", bm32, k6_k3))
    bm = solve_turns("blockmatch_v2 from block_matching_init", bm32, k6_k3, init_flow=bm_flow,
                     verbose=True)
    require(bm.AEPE[0] < rand.AEPE[0] and bm.AEPE[-1] < rand.AEPE[-1],
            f"blockmatch_v2: AEPE from the block-matching init {bm.AEPE[0]:.4f} at it=1, "
            f"{bm.AEPE[-1]:.4f} at the end, each below the random init's {rand.AEPE[0]:.4f}, "
            f"{rand.AEPE[-1]:.4f}")
    segment_turns("blockmatch_v2", bm32, pg.make_problem(bm32, I1, I2, fr, dev), bm.state)
    wres = aepe_falls("tpu_fast window_rg=2", counted_solve(
        "tpu_fast window_rg=2", wf32, launch_counts(K1=1, K2=1), verbose=True))
    segment_ms("tpu_fast window_rg=2", wf32, wp32, wres.state)
    del wp32
    # the windowed bicubic term through K12, beside K3 (the main path of K12's launches)
    wb32 = GQMAPConfig.full_mixture(window_rg=2, quad_chunk=27, its=300, eval_every=300)
    wbres = aepe_falls("full_mixture window_rg=2", counted_solve(
        "full_mixture window_rg=2", wb32, launch_counts(K3=1, K12=1), verbose=True))
    segment_ms("full_mixture window_rg=2", wb32, pg.make_problem(wb32, I1, I2, fr, dev),
               wbres.state)
    lb32 = GQMAPConfig.legacy_v2(data_term="bicubic", its=300, eval_every=300)
    aepe_falls("legacy_v2 bicubic", counted_solve("legacy_v2 bicubic", lb32,
                                                  launch_counts(K3=1, K12=1)))
    del wbres

    # legacy_v1: its quadratic prior is Problem.init_flow, which solve() does
    # not set (as in the JAX package), so it runs through the segment runner;
    # with a dominant prior (quad_var = 0.05) the means track the
    # block-matching flow (tests/test_solver.py:178-199). K10 computes the
    # prior's sums and K11 the truncated-quadratic edges', once a sweep each
    v1_32 = GQMAPConfig.legacy_v1(its=300, quad_var=0.05)
    v1p = pg.make_problem(v1_32, I1, I2, fr, dev)._replace(
        init_flow=torch.as_tensor(bm_flow, device=dev))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    for f in kfns.values():
        f.launches = 0
    v1init = pg.init_state(v1_32, fr, (H, W), device=dev)
    v1st, v1n, v1e, *_ = pg.make_segment_runner(v1_32, (H, W))(v1p, v1init, 300)
    torch.cuda.synchronize()
    v1peak = (torch.cuda.max_memory_allocated() - held) / 2**30
    by_path["legacy_v1"] = counts = {k: f.launches for k, f in kfns.items()}
    med = float(v1st.muu[0, 1:-1, 1:-1].median())
    want_u = float(np.median(bm_flow[1:-1, 1:-1, 0]))
    require(counts == launch_counts(K10=v1n, K11=v1n) and v1n == 300,
            f"legacy_v1: launch counters {counts}: K10 and K11 once a sweep of "
            f"{v1n} (300 asked)")
    require(bool(torch.isfinite(v1e[:v1n]).all()), "legacy_v1: energy finite over every sweep")
    require(abs(med - want_u) < 0.15, f"legacy_v1: median interior mean u {med:.4f} within 0.15 "
                                      f"of the prior's {want_u:.4f} after {v1n} sweeps")
    # ms a sweep of 300-sweep graph segments: converged (from the run's final
    # state) and from the init
    v1seg = pg.make_segment_runner(dataclasses.replace(v1_32, its=100000, tor=0.0), (H, W))
    v1ms = {}
    for sname, st in (("converged", v1st), ("from init", v1init)):
        v1seg(v1p, st, 5)
        t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0.record()
        done = v1seg(v1p, st, 300)[1]
        t1.record()
        torch.cuda.synchronize()
        require(done == 300 and v1seg.route == "graph",
                f"legacy_v1 segment {sname}: {done} sweeps on route {v1seg.route!r}")
        v1ms[sname] = t0.elapsed_time(t1) / 300
    # on the run's own state (after its 300 sweeps): K11 v2's classes, K10's
    # and K11's times in both variants; then a segment through v1 (the
    # launches of v1's records)
    from gqmap_tpu_torch.kernels import quad_gq

    qa10, qa11 = quad_args(v1st, pg._prior(v1p), torch.float32)
    counts = torch.zeros(len(quad_gq.CLASS_COUNTS), dtype=torch.int64, device=dev)
    quad_gq.truncquad_edge_gq_cuda(*qa11, v1_32.K, v1_32.gama, v1_32.dta, counts=counts)
    on_state = record["K11"]["classes"]["legacy_v1 after 300 sweeps"] = quad_classes(
        counts.tolist())
    times = {}
    for variant in QUAD_VARIANTS:
        times[f"K10 {variant}"] = kernel_ms(lambda: quad_gq.quad_node_gq_cuda(
            *qa10, v1_32.K, v1_32.quad_var, variant=variant))[0]
        times[f"K11 {variant}"] = kernel_ms(lambda: quad_gq.truncquad_edge_gq_cuda(
            *qa11, v1_32.K, v1_32.gama, v1_32.dta, variant=variant))[0]
    for c in QUAD_COOP:
        times[f"K11 v2 coop_lanes {c}"] = kernel_ms(lambda: with_coop_lanes(
            c, quad_gq.truncquad_edge_gq_cuda)(*qa11, v1_32.K, v1_32.gama, v1_32.dta))[0]
    record["K11"]["on_legacy_v1_state_ms"] = times
    log(f"  legacy_v1 after 300 sweeps (median sigma_u "
        f"{float(v1st.sigmau.median()):.4f}): K11 v2's classes {json.dumps(on_state)}; ms "
        f"{json.dumps(times)}")
    del qa10, qa11
    default = quad_gq._DEFAULT_VARIANT
    quad_gq._DEFAULT_VARIANT = "v1"
    try:
        for f in kfns.values():
            f.launches = 0
        seg1 = pg.make_segment_runner(dataclasses.replace(v1_32, its=100000, tor=0.0), (H, W))
        n1 = seg1(v1p, v1st, QUAD_V1_SWEEPS)[1]
    finally:
        quad_gq._DEFAULT_VARIANT = default
    by_path[f"legacy_v1 K10/K11 v1 ({QUAD_V1_SWEEPS} sweeps)"] = c1 = {
        k: f.launches for k, f in kfns.items()}
    require(n1 == QUAD_V1_SWEEPS and c1["K10"] == c1["K11"] > 0,
            f"legacy_v1 through K10/K11 v1: {n1} sweeps, launch counters {c1}")
    del seg1
    record["legacy_v1"] = dict(segment_ms_per_sweep=v1ms, run_GiB_above_held=v1peak,
                               card=smi("name,power.limit"))
    log(f"  legacy_v1 on {record['legacy_v1']['card']}: 300-sweep graph segments "
        f"{v1ms['converged']:.4f} ms a sweep converged, {v1ms['from init']:.4f} from init; the "
        f"300-sweep run's peak {v1peak:.4f} GiB above the {held / 2**30:.3f} GiB held (its "
        "capture included)")
    del v1p, v1seg

    # ---- 17. legacy_v2's sweep: time, node term, table build, memory
    log("phase legacy_v2 sweep")
    torch.cuda.synchronize()
    t = time.time()
    v2p = pg.make_problem(v2_32, I1, I2, fr, dev)
    torch.cuda.synchronize()
    t_problem = time.time() - t
    I2d = torch.as_tensor(I2, dtype=torch.float32, device=dev)
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t = time.time()
    tab = upsample_cubic(I2d, v2_32.rfc)
    torch.cuda.synchronize()
    t_up = time.time() - t
    up_peak = torch.cuda.max_memory_allocated() - base
    del tab
    seg_ms = segment_turns("legacy_v2", v2_32, v2p, v2res.state)
    v2st = v2res.state
    a3 = torch.softmax(v2st.w, 0).reshape(1, 1, 1)
    site5 = (v2st.muu, v2st.muv, v2st.sigmau, v2st.sigmav, v2st.pn)
    k6_rest = (v2_32.K, v2_32.lambdad, v2_32.epsn, v2_32.rfc, v2_32.window_rg)
    k6_v1 = functools.partial(k6_fn, variant="v1")

    def v2_node_term(fn=k6_fn, s5=site5):
        """the node term, K6 (or its plain version) and finalize"""
        raw = fn(v2p.I1, v2p.I2_tab, *s5, *k6_rest, pads=v2p.nearest_pads)
        return finalize(raw, a3, v2st.sigmau, v2st.sigmav, v2st.pn, v2st.temperature, NODE)

    v2sweep = pg.make_sweep(v2_32, (H, W))
    split = dict(sweep=time_ms(lambda: v2sweep(v2p, v2st), 10), node=time_ms(v2_node_term, 10),
                 node_v1=time_ms(lambda: v2_node_term(k6_v1), 10),
                 node_plain=time_ms(lambda: v2_node_term(functools.partial(
                     nearest_gq.nearest_gq_torch, quad_chunk=v2_32.quad_chunk)), 3))
    split["node_share"] = split["node"] / split["sweep"]
    split["segment_ms_per_sweep"] = seg_ms

    def k6_on(s5, what, n=TIMING[1]):
        """K6 alone in both variants on a state (bit for bit the same sums),
        each beside its bound: v1's from the table sectors its lookups touch"""
        sectors = nearest_gq.lookup_sectors(v2p.I2_tab, *s5, v2_32.K, v2_32.rfc,
                                            v2_32.window_rg)[1]
        args = (v2p.I1, v2p.I2_tab, *s5, *k6_rest)
        require(all(torch.equal(x, y) for x, y in zip(
            k6_v1(*args), k6_fn(*args, variant="v2", pads=v2p.nearest_pads))),
            f"K6 on {what}: v2's sums are v1's, bit for bit")
        out = dict(sectors=sectors)
        for variant in nearest_gq.VARIANTS:
            ms = kernel_ms(lambda: k6_fn(*args, variant=variant, pads=v2p.nearest_pads), n=n)
            work = roofline.k6_work(tuple(s5[0].shape), v2_32.K, v2_32.window_rg, sectors,
                                    variant=variant)
            out[variant] = dict(ms=ms[0], ms_min=ms[1], **bound(work))
        log(f"  K6 on {what}: " + "; ".join(
            f"{v} (median, min) ({out[v]['ms']:.4f}, {out[v]['ms_min']:.4f}) ms, "
            f"{fmt_bound(out[v])}" for v in nearest_gq.VARIANTS) + f"; {sectors} distinct sectors")
        return out

    # K6 alone on the solve's final state, and on states along a legacy_v2
    # solve from its init (the graph route's state after 0, 10, 30, 100 and
    # 300 sweeps), v1 against v2
    record["K6"]["legacy_v2 solve state"] = k6_on(site5, "legacy_v2's solved state (after 300 "
                                                         "sweeps)")
    along = record["K6"]["along a legacy_v2 solve"] = {}
    runner = pg.make_segment_runner(dataclasses.replace(v2_32, tor=0.0, its=v2_32.its + 40),
                                    (H, W))
    st, done = pg.init_state(v2_32, fr, (H, W), device=dev), 0
    for n in (0, 10, 30, 100, 300):
        if n > done:
            st, done = runner(v2p, st, n - done)[0], n
        along[n] = k6_on((st.muu, st.muv, st.sigmau, st.sigmav, st.pn),
                         f"the state after {n} sweeps from legacy_v2's init", n=20)
    del runner
    record["legacy_v2"] = dict(split, make_problem_s=t_problem, upsample_cubic_s=t_up,
                               upsample_cubic_GiB_above_held=up_peak / 2**30,
                               card=smi("name,power.limit"))
    log(f"  legacy_v2 on {record['legacy_v2']['card']}: {split['segment_ms_per_sweep']:.4f} ms a "
        f"sweep (30-sweep segment from its solve's final state), one sweep {split['sweep']:.4f} "
        f"ms of which the node term (K6 v2 and finalize) {split['node']:.4f} ms "
        f"({100 * split['node_share']:.1f}%; through K6 v1 {split['node_v1']:.4f} ms, through the "
        f"plain version {split['node_plain']:.4f} ms); make_problem "
        f"{t_problem:.3f} s, upsample_cubic (376x452 -> {tuple(v2p.I2_tab.shape)}) {t_up:.3f} s "
        f"and {up_peak / 2**30:.3f} GiB at peak; solve peak {record['peak_GiB']['legacy_v2']:.3f}"
        " GiB")

    # ---- 18. one autodiff sweep at full width (K6's value and K14 once each)
    log("phase autodiff sweep")
    ad32 = dataclasses.replace(v2_32, gradient_estimator="autodiff")
    adsweep = pg.make_sweep(ad32, (H, W))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    ad_ms = time_ms(lambda: adsweep(v2p, v2st), 1)
    for f in kfns.values():
        f.launches = 0
    ad1, adaux = adsweep(v2p, v2st)
    torch.cuda.synchronize()
    ad_peak = torch.cuda.max_memory_allocated() - base
    by_path["legacy_v2 autodiff (one sweep)"] = counts = {k: f.launches for k, f in kfns.items()}
    moved = max(float((getattr(ad1, f) - getattr(v2st, f)).abs().max())
                for f in ("muu", "muv", "sigmau", "sigmav", "pn", "rou"))
    finite = all(bool(torch.isfinite(getattr(ad1, f)).all()) for f in ad1._fields)
    require(finite and bool(torch.isfinite(adaux.energy)) and moved > 0,
            f"legacy_v2 autodiff sweep: finite gradients and state (largest step {moved:.3e}), "
            f"energy {float(adaux.energy):.6e}")
    require(counts == launch_counts(K6=1, K14=1),
            f"autodiff: launch counters {counts}: K6 (the lookup's value) and K14 once each")
    record["legacy_v2_autodiff"] = dict(sweep_ms=ad_ms, GiB_above_held=ad_peak / 2**30)
    log(f"  legacy_v2 autodiff: one sweep {ad_ms:.3f} ms, peak {ad_peak / 2**30:.3f} GiB above "
        "what the script held")
    del v2p

    # ---- 18b-c. the autodiff estimator's kernels and its three graph segments
    kernels_autodiff(dev, record, I1, I2, issue_ms)
    autodiff_segments(dev, record, by_path, kfns)

    # ---- 18e-f. K16 and K13 at patch 4, and their three paths' graph segments
    kernels_chain_block(dev, record, I1, I2, issue_ms)
    chain_block_segments(dev, record, by_path, kfns)

    # ---- 18d. shapes past a kernel's limit: K1 in groups, the plain sums on "auto"
    d7_phase(dev, record, by_path, kfns)

    # ---- 19-23. the drivers, the command line and K3 on the pyramid's lattice
    drivers(dev, record, by_path, kfns, segment_ms)

    # ---- 24. the multi-device solve: 4 ranks on the card (gloo) and 1 over NCCL
    sharded(dev, record, by_path, float(res.AEPE[SHARDED_SOLVE_ITS - 1]))

    # ---- 25-29. the Chebyshev term, the roofline harness, bench, D4
    chebyshev(dev, record, by_path, kfns, st64, cast)
    roofline_phase(dev, record, by_path, kfns, ceil)
    bench_phase(record)
    d4_phase(dev, record)
    graph_phase(dev, record, by_path, {**kfns, **ufns})
    update_phase(dev, record, by_path, ufns)
    profiles_phase(dev, record)

    # only the runs that set a kernel's counter to 0 and read it list it
    for k in (*kfns, *ufns):
        record[k]["launches_by_path"] = {path: c[k] for path, c in by_path.items() if k in c}
    log("  launches per path: " + json.dumps(by_path))
    log("  records: " + json.dumps({k: v for k, v in record.items()
                                     if k not in kfns and k not in ufns}))

    kernels = [
        dict(name="cos_mode_sums (K1)", route="cuda", source="gqmap_tpu_torch/csrc/cosine_gq.cu",
             replaces="gqmap_tpu/kernels/cosine_gq.py:305", launches=launches["K1"],
             **record["K1"]),
        dict(name="edge_reduced_grads (K2)", route="cuda",
             source="gqmap_tpu_torch/csrc/edge_reduced_gq.cu",
             replaces="gqmap_tpu/kernels/edge_reduced_gq.py:113", launches=launches["K2"],
             **record["K2"]),
        dict(name="edge_gq (K3)", route="cuda", source="gqmap_tpu_torch/csrc/edge_gq.cu",
             replaces="gqmap_tpu/kernels/edge_gq.py:97", launches=flaunch["K3"],
             **record["K3"]),
        dict(name="node_gq (K4, v2)", route="cuda", source="gqmap_tpu_torch/csrc/node_gq.cu",
             replaces="gqmap_tpu/ops/gq.py:93 on gqmap_tpu/ops/potentials.py:44 (XLA scan, "
                      "no Pallas)", launches=flaunch["K4"], **record["K4"]),
        dict(name="cheb_gq (K5, v2)", route="cuda", source="gqmap_tpu_torch/csrc/cheb_gq.cu",
             replaces="gqmap_tpu/ops/gq.py:93 on gqmap_tpu/ops/chebyshev.py:126 (XLA scan, "
                      "no Pallas)", launches=by_path["full_mixture chebyshev solve"]["K5"],
             **record["K5"]),
        dict(name="nearest_gq (K6, v2)", route="cuda",
             source="gqmap_tpu_torch/csrc/nearest_gq.cu",
             replaces="gqmap_tpu/ops/gq.py:93 on gqmap_tpu/ops/potentials.py:100/:142 (XLA "
                      "scan, no Pallas)", launches=by_path["legacy_v2"]["K6"], **record["K6"]),
        dict(name="nearest_chain_gq (K7, v2)", route="cuda",
             source="gqmap_tpu_torch/csrc/nearest_gq.cu",
             replaces="gqmap_tpu/ops/gq.py:339 on gqmap_tpu/ops/potentials.py:211 (XLA scan, "
                      "no Pallas)", launches=by_path["legacy_v3"]["K7"], **record["K7"]),
        dict(name="site_update (K8, v2)", route="cuda",
             source="gqmap_tpu_torch/csrc/sweep_update.cu",
             replaces="gqmap_tpu/models/gqmap.py:386 compute_grads and :552 one_pass (XLA "
                      "fusion in the jit-compiled sweep, no Pallas)", launches=launches["K8"],
             **record["K8"]),
        dict(name="sweep_tail (K9, v2: run by K8 v2's last CTA, inside its launch)",
             route="cuda", source="gqmap_tpu_torch/csrc/sweep_update.cu",
             replaces="gqmap_tpu/models/gqmap.py:572-616 the passes' sums, alpha update, anneal "
                      "and counter (XLA fusion, no Pallas)", launches=launches["K9"],
             launches_of_its_own=launches["K9 v1"], **record["K9"]),
    ]
    # K10 and K11 under each variant: the default's launches from the legacy_v1
    # run, the other's from its segment after it
    for kern, fname, line in (("K10", "quad_node_gq", 321), ("K11", "truncquad_edge_gq", 296)):
        rq = record[kern]
        for variant in QUAD_VARIANTS:
            runs = ("legacy_v1" if variant == rq["variant"] else
                    f"legacy_v1 K10/K11 {variant} ({QUAD_V1_SWEEPS} sweeps)")
            extra = ({k: rq[k] for k in ("classes", "cutoff_flips", "on_legacy_v1_state_ms")}
                     if kern == "K11" and variant == "v2" else {})
            kernels.append(dict(
                name=f"{fname} ({kern}, {variant})", route="cuda",
                source="gqmap_tpu_torch/csrc/quad_gq.cu",
                replaces=f"gqmap_tpu/ops/gq.py:93 on gqmap_tpu/ops/potentials.py:{line} (XLA "
                         "scan, no Pallas)", launches=by_path[runs][kern], launches_run=runs,
                **rq[variant], **extra))
    # K12 under each variant: the default's launches from the main path's solve,
    # the other's from its turn in the graph phase
    k12 = record["K12"]
    for variant in sorted(window_gq.VARIANTS, key=lambda v: v != k12["variant"]):
        runs = ("full_mixture window_rg=2" if variant == k12["variant"] else
                f"graph full_mixture window_rg=2 converged K12 {variant} (100 sweeps)")
        kernels.append(dict(
            name=f"window_gq (K12, {variant})", route="cuda",
            source="gqmap_tpu_torch/csrc/node_gq.cu",
            replaces="gqmap_tpu/ops/gq.py:93 on gqmap_tpu/ops/potentials.py:142 (XLA scan, no "
                     "Pallas)", launches=by_path[runs]["K12"], launches_run=runs,
            **{k: v for k, v in k12[variant].items() if k != "variant"},
            legacy_v2_bicubic=k12["legacy_v2 bicubic"][variant],
            border_fallback_share=k12["border_fallback_share"], instances={
                k: v for k, v in k12["instances"].items() if f" {variant} " in k}))
    # K13-K15 (K13 and K14 under each variant): launches from their path's
    # timed graph segment in that variant's first turn
    ad = record["autodiff"]
    for kern, fname, path, replaces in (
            ("K13", "node_chain_gq", "full_mixture autodiff",
             "gqmap_tpu/ops/gq.py:299 gq_ei on gqmap_tpu/ops/potentials.py:44, under jax.grad "
             "(XLA scan, no Pallas)"),
            ("K14", "edge_chain_gq", "full_mixture autodiff",
             "gqmap_tpu/ops/gq.py:299 gq_ei on the Charbonnier edge potential, under jax.grad "
             "(XLA scan, no Pallas)"),
            ("K15", "edge_diff_adjoint", "tpu_fast autodiff",
             "gqmap_tpu/ops/gq.py:430 gq_ei_diff on the Charbonnier difference potential, "
             "under jax.grad (XLA scan, no Pallas)")):
        rk = record[kern]
        for variant in AUTODIFF_VARIANTS[kern]:
            source = ("gqmap_tpu_torch/csrc/node_gq.cu" if (kern, variant) == ("K13", "v2")
                      else "gqmap_tpu_torch/csrc/autodiff_gq.cu")
            fields = {**rk[variant], **{k: v for k, v in rk.items()
                                        if k in ("shape", "K", "l1_route_share")}}
            kernels.append(dict(
                name=f"{fname} ({kern}, {variant})",
                route="cuda", source=source, replaces=replaces,
                launches=ad[path][variant]["launches"][kern],
                launches_run=f"{path} {variant} ({AUTODIFF_SWEEPS} sweeps)",
                **{k: v for k, v in fields.items()
                   if k not in ("phase_s", "v1", "v2", "variant", "v2_equals_v1_checks")}))
    # K16 and K13 at patch 4: launches from their paths' first kernels turn
    # (phase 18f)
    aw = record["autodiff_window"]
    k16 = record["K16"]
    kernels.append(dict(
        name="node_window_chain_gq (K16)", route="cuda", source="gqmap_tpu_torch/csrc/node_gq.cu",
        replaces="gqmap_tpu/ops/gq.py:299 gq_ei on gqmap_tpu/ops/potentials.py:142 "
                 "(make_node_pot_windowed, base bicubic), under jax.grad (XLA scan, no Pallas)",
        launches=aw["full_mixture window_rg=2 autodiff"]["kernels"]["launches"]["K16"],
        launches_run=f"full_mixture window_rg=2 autodiff kernels ({AUTODIFF_SWEEPS} sweeps)",
        **{k: v for k, v in k16.items() if k not in ("phase_s", "checks")}))
    kernels.append(dict(
        name="node_chain_gq (K13, v2, patch 4)", route="cuda",
        source="gqmap_tpu_torch/csrc/node_gq.cu",
        replaces="gqmap_tpu/ops/gq.py:299 gq_ei on gqmap_tpu/ops/potentials.py:44 "
                 "(make_node_pot_bicubic, patch 4), under jax.grad (XLA scan, no Pallas)",
        launches=aw["super_entropy autodiff"]["kernels"]["launches"]["K13"],
        launches_run=f"super_entropy autodiff kernels ({AUTODIFF_SWEEPS} sweeps)",
        library_ms=None, library_reason=k16["library_reason"], **record["K13"]["patch 4"]))
    if FAILURES:
        log(f"chip_smoke FAILED: {FAILURES}")
        raise SystemExit(1)
    log(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if "--rank" in sys.argv:
        import argparse

        ap = argparse.ArgumentParser()
        for flag in ("--rank", "--world", "--port"):
            ap.add_argument(flag, type=int, required=True)
        ap.add_argument("--dir", required=True)
        a = ap.parse_args()
        sys.exit(rank_main(a.rank, a.world, a.port, a.dir))
    sys.exit(main())
