from repro_torch.serving.engine import ServeConfig, ServingEngine, make_serve_step
