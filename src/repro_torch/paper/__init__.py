"""The paper's headline gate on the port: the scenario, the Fig. 5
training run and the ≥ 80 % gate — own copies of the JAX package's
``benchmarks/{common,fig5_training,priced_training}.py``, kept in the
package so that the benchmarks stay as they are.

    python -m repro_torch.paper.priced_training            # on the GPU
    python -m repro_torch.paper.priced_training --device cpu
"""
