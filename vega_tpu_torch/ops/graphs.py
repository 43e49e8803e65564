"""A function of static device buffers as one CUDA graph.

The samplers' device-resident functions (one nested-sampling iteration's
slice evolution, one HMC trajectory) are hundreds to thousands of small
kernels each; replayed as one graph they cost one dispatch. The
spline-Legendre kernels captured inside count their launches at each
replay, and only there: the replay and the count are one call.
"""

from __future__ import annotations

import torch

from . import spline_combine


class CapturedGraph:
    """`fn()` captured as a torch.cuda.CUDAGraph on `device`.

    fn takes no argument: it reads tensors that stay where they are (the
    caller's static input buffers) and returns a tensor or a tuple of
    tensors, which become the static results `out`, overwritten by every
    replay. Before the capture fn runs `warmups` times on a side stream,
    which keeps one-time work (building the kernels' library, the
    libraries' handles and workspaces, the autograd engine's start) out
    of the graph. A capture or replay that fails raises."""

    def __init__(self, fn, device, warmups=1):
        # captured with `device` current: the graph's pool, its capture
        # stream and every launch inside belong to that device
        self.device = torch.device(device)
        with torch.cuda.device(self.device):
            side = torch.cuda.Stream(self.device)
            side.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(side):
                for _ in range(warmups):
                    fn()
            torch.cuda.current_stream(self.device).wait_stream(side)
            self.graph = torch.cuda.CUDAGraph()
            with spline_combine.captured_launches() as self.launches:
                with torch.cuda.graph(self.graph):
                    self.out = fn()

    def replay(self):
        """Replay the graph on the device it was captured on, count its
        kernel launches, and return the static results."""
        with torch.cuda.device(self.device):
            self.launches.replay(self.graph)
        return self.out
