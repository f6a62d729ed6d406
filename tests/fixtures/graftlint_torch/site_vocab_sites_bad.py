"""Seeded-bad fixture for the port's ``site-vocab`` form: the census is
built by a site-listing method (``{site: ... for site in
self._program_sites()}``), as the port's ``ServeEngine`` builds it.
Three findings: the dispatched ``verify`` site is listed nowhere, the
listed ``draft`` is missing from SITES, and SITES's ``insert`` is
stale."""


class FaultPlan:
    SITES = ("tick", "prefill", "insert")


class Engine:
    def compile_counts(self):
        return {site: len(self._sigs.get(site, ()))
                for site in self._program_sites()}

    def _program_sites(self):
        sites = ["tick", "prefill"]
        if self._spec:
            sites.append("draft")
        return sites

    def step(self):
        self._device_call("prefill", self._prefill, None)
        self._device_call("draft", self._draft, None)
        self._device_call("verify", self._verify, None)
        return self._device_call("tick", self._tick)
