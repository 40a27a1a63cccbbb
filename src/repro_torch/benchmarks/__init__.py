"""Twins of the paper's scripts in ``benchmarks/``, on the port.

Each module keeps the reference script's name and functions and runs
with ``python -m repro_torch.benchmarks.<name>`` on the card, or on the
CPU with ``--device cpu``. Training runs go through
``repro_torch.api.run_experiment`` and are cached under the port's own
``results/torch/`` (or the ``cache_dir`` a caller passes), never under
the JAX package's ``results/paper/``.

  paper_repro          ``make_clients`` / ``run_scheme`` delegates
  table1_comm_costs    Table I: per-round bytes of every scheme
  fig2_comm_efficiency Fig. 2: accuracy against cumulative uplink MB
  fig3_heterogeneity   Fig. 3: SD of each base block over the modulars
  fig4_matrix          Fig. 4: the base x modular accuracy matrix
  run                  the Table I and Fig. 2-4 sections in one run
  async_vs_sync        sync barrier against async ticks at matched uplink
  fleet_scale          cohort rounds at N >> C: bytes and wall flat in N
  kernel_bench         each kernel's cost row, and its times on the card
  roofline_report      the dry-run's roofline table and the wire table
  ifl_vs_dp_collectives  a round's boundary bytes against DP's all-reduce
  perf_probe           a dry-run row's terms over config variants
  gen_experiments      EXPERIMENTS.md from the dry-run's files and the runs
  serving_bench        the serving sweep (sequential, horizon 1, fused)
"""
