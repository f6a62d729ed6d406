"""Good twin: the port's engine form — the census is
built by a site-listing method, the faults vocabulary lives in
``pddl_tpu_torch/serve/faults.py``."""


class ServeEngine:
    def compile_counts(self):
        return {site: 1 for site in self._program_sites()}

    def _program_sites(self):
        sites = ["tick"]
        sites.append("prefill")
        return sites

    def step(self):
        self._device_call("prefill", self._prefill, None)
        return self._device_call("tick", self._tick)
