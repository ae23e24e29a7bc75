"""Decoupled self-play workers and trainer over shared storage (port of
`contrib/distr-env/`): ``python -m dream_go_torch.distr_env.run_worker``
and ``python -m dream_go_torch.distr_env.run_train``."""
