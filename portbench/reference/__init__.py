"""Plain reference of the benchmark's scenes: plain NumPy and PyTorch only.

It imports nothing of the program under test. `scene.build` regenerates a
configuration's mesh and constants from its own parameters (a frozen copy
of the box-grid generator); `judge.judge_chain` holds a chain of time
steps to the scene's incremental-potential stationarity, its scripted
handles and its guarantees (no inverted tet, no interpenetration).
"""
