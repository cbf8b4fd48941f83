"""Spatial smoothing of noisy scattered data with a Laplacian penalty.

Run on CPU:  JAX_PLATFORMS=cpu python examples/smoothing.py
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

import fdapde_core_tpu as fdm
from fdapde_core_tpu.geometry.structured import unit_square_mesh
from fdapde_core_tpu.models import SmoothingRegression

PI = np.pi
rng = np.random.default_rng(0)
locs = rng.uniform(0, 1, size=(2000, 2))
truth = np.sin(2 * PI * locs[:, 0]) * np.cos(2 * PI * locs[:, 1])
y = truth + 0.2 * rng.normal(size=2000)

model = SmoothingRegression(unit_square_mesh(24), -fdm.laplacian())
best_lambda, errors = model.select_lambda(locs, y, [1e-2, 1e-1, 1.0, 10.0])
pred = np.asarray(model.predict(locs))
print("selected lambda:", best_lambda)
print("fit RMSE vs truth:", float(np.sqrt(((pred - truth) ** 2).mean())))
