"""The benchmark of the PyTorch and CUDA port: ``run.py`` runs one cell of
``BENCHMARK.json``.

Adding a configuration.  A cell names a configuration and a traffic mix,
and the harness finds each by its name: ``configs/<name>.json`` (the
sensor, the program's ``parameters``, the reference's settings and the
``limits`` of the numbers ``correct`` compares; a number that does not
apply to the deployment is left out of ``limits``), ``traffic/<name>.json``
(the world, the path, the warm-up and the checked scans) and
``metrics/<name>.py`` for each metric (``read(ctx)``).  What a deployment
does beyond replaying its sensor stream into a fresh ``SlamWrapper``, such
as localizing on a prior map, it brings as extensions: the configuration
lists ``"extensions": ["<name>", ...]``, and each is a module
``extensions/<name>.py`` that defines any of three hooks.

- ``prepare(config, traffic, world, truth, out_dir, ss)``: once, in
  ``traffic_gen.generate``, after the sensor stream is written, with the
  world's points on the device, the true poses, the sequence's directory
  and a seed stream of its own; what it returns is ``seq.extras[name]``.
- ``start(slam, seq, config, device)``: on every fresh ``SlamWrapper``, in
  the warm-up and in each mission of the window, after the initial
  transform and before the first scan; it calls only the program's own
  entry points, and its time in a mission counts in the window.
- ``judge(capture, seq, config, device, control) -> {number: value}``:
  its numbers join ``checking.judge``'s readings and are compared with the
  configuration's ``limits``, where each has to have its limit; with
  ``control`` true it reads the control, for ``control.py``.  It reads
  the sampled scans (``session.ScanSample``: the decoded cloud, the poses,
  the active table before and after the call) and the rest of the
  ``capture``.  Its reference lives in ``reference/``, which imports
  nothing of the program.

A configuration with no extensions runs no hook and draws the same seed
streams.
"""
