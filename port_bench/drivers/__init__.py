"""Drivers: one module per kind of traffic, named by a workload file's
`driver` key; each exposes `Cell(cfg, workload, seed, device)` with
`setup`, `window`, `traced`, `counts`, `release` and `check`."""
