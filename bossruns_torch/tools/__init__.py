"""Measuring and operating scripts of the port, each run as
``python -m bossruns_torch.tools.<name>``: bench_aligner, bench_scale,
profile_step, profile_seed, profile_aeons_strategy, check_decision_parity
and check_sequencer_connection."""
