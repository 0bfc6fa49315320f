"""Device engines and the CUDA kernels behind them."""
