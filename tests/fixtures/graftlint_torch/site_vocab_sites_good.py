"""Good twin of ``site_vocab_sites_bad.py``: the listed sites, the
dispatched sites and SITES are one vocabulary. Must lint clean."""


class FaultPlan:
    SITES = ("tick", "prefill", "draft", "verify")


class Engine:
    def compile_counts(self):
        return {site: len(self._sigs.get(site, ()))
                for site in self._program_sites()}

    def _program_sites(self):
        sites = ["tick", "prefill"]
        if self._spec:
            sites += ["draft", "verify"]
        return sites

    def step(self):
        self._device_call("prefill", self._prefill, None)
        self._device_call("draft", self._draft, None)
        self._device_call("verify", self._verify, None)
        return self._device_call("tick", self._tick)
