"""The benchmark's fixed arithmetic: published peaks, least times of the
kernels, the work of a tick or step, and the reduction of a profiler trace."""
