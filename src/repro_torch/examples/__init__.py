"""The reference's ``examples/`` on the port, one module each, run as
``python -m repro_torch.examples.<name>`` (on the card unless ``--device
cpu``): ``quickstart``, ``compress_and_eval``, ``train_factorized_lm``,
``serve_dynamic_batching`` and ``serve_async_frontend``. Each module's
``main(argv=None)`` prints what the reference's example prints and
returns those numbers as a dict; its functions take params (or a seed),
so tests can feed bridged reference params."""
