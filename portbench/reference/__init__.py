"""The plain reference of the benchmark: HP-VAE-GAN in plain PyTorch and
NumPy, f32, stock operations only.  It imports nothing of the measured
package and takes nothing the package made: the benchmark hands both the
same inputs (weights, frames, draws), and the reference works out again
whatever the package derives from them."""
