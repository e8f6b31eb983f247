"""Launch helpers of the port: the device mesh (``launch/mesh.py``) and the
serve and train launchers (``python -m repro_torch.launch.serve`` and
``python -m repro_torch.launch.train``)."""
