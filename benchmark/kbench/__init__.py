"""The benchmark of the scheduler's PyTorch/CUDA port (``kubetpu_torch``).

Modules:

* ``registry``  -- reads BENCHMARK.json and finds a cell's configuration,
  traffic mix and per-layer metric readers by name;
* ``plugins``   -- finds the pod features (``features/<key>.py``) and score
  plugins (``scores/<Plugin>.py``) a mix or a configuration names;
* ``spec``      -- builds a cell's world and its closed-loop traffic from the
  seed as plain data (no torch, nothing of the program);
* ``reference`` -- the plain NumPy reference: a ledger of the cluster as
  each cycle saw it, the checks that decide ``correct`` and the control
  placers that break the guarantees;
* ``objects``   -- turns the plain data into the program's API objects;
* ``driver``    -- runs one cell against ``kubetpu_torch.scheduler``;
* ``profiling`` -- the device trace: union of kernel intervals, idle gaps;
* ``k1_bound``  -- a frozen count of the bytes and operations one launch of
  the propose kernel needs, and the card's published peaks.
"""
