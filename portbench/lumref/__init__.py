"""The benchmark's plain reference: a frozen copy of the port's plain
PyTorch path (``render/wavefront.py``, ``render/device_scene.py``,
``ops/``, ``scene/``, ``bvh/``, ``device.py``, ``utils/`` of
``luminary_tpu_torch`` as of the benchmark's first version).

Every hand-written kernel path is taken out: each operation runs its plain
version on whatever device its tensors lie on, so docstrings that speak of
a launch on the card describe the program, not this copy. Two changes of
substance: the native BVH builder builds into the checkout's
``build/portbench/bvh/``, and the camera jitter takes each lane's own
sample id (``ops/camera.py``), so that one wavefront can hold many samples.
Nothing here imports the program; ``harness/reference.py`` drives it.
"""
