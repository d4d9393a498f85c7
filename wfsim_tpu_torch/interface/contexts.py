"""Preconfigured strax contexts (optional: requires strax + straxen;
counterpart of wfsim_tpu/interface/contexts.py, registering the port's
plugins).

Same factory surface as the reference (reference: wfsim/contexts.py:9-292):
``xenonnt_simulation_offline``, ``xenonnt_simulation``, ``xenon1t_simulation``.
The corrections-management (CMT) wiring maps fax config names to CMT options
for the simulation side while keeping processing-side options independent.
"""
from __future__ import annotations

import logging

log = logging.getLogger('wfsim_tpu_torch.interface')

try:
    import strax
    import straxen
    HAVE_STRAX = True
except ImportError:
    HAVE_STRAX = False

__all__ = ['HAVE_STRAX']

if HAVE_STRAX:
    from . import strax_plugins as wf_plugins

    __all__ += ['xenonnt_simulation_offline', 'xenonnt_simulation',
                'xenon1t_simulation']

    def xenonnt_simulation_offline(output_folder: str = './strax_data',
                                   wfsim_registry: str = 'RawRecordsFromFaxNT',
                                   run_id: str = None,
                                   global_version: str = None,
                                   fax_config: str = None,
                                   **kwargs):
        """Simulation context with corrections pinned to a global version
        (reference: wfsim/contexts.py:9-73)."""
        if run_id is None:
            raise ValueError('Specify a run_id to load the corrections')
        if global_version is None:
            raise ValueError('Specify a correction global version')
        if fax_config is None:
            raise ValueError('Specify a fax_config file')

        st = straxen.contexts.xenonnt_simulation(
            output_folder=output_folder,
            global_version=global_version,
            fax_config=fax_config,
            **kwargs) if hasattr(straxen.contexts, 'xenonnt_simulation') else \
            strax.Context(
                storage=strax.DataDirectory(output_folder),
                config=dict(detector='XENONnT', fax_config=fax_config,
                            check_raw_record_overlaps=True,
                            **straxen.contexts.xnt_common_config),
                **straxen.contexts.xnt_common_opts)
        wfsim_plugin = getattr(wf_plugins, wfsim_registry)
        st.register(wfsim_plugin)
        for plugin_name in wfsim_plugin.provides:
            assert plugin_name in st._plugin_class_registry
        st.apply_cmt_version(global_version)
        return st

    def xenonnt_simulation(output_folder='./strax_data',
                           wfsim_registry='RawRecordsFromFaxNT',
                           cmt_run_id_sim=None,
                           cmt_run_id_proc=None,
                           cmt_version='global_ONLINE',
                           fax_config='fax_config_nt_design.json',
                           overwrite_from_fax_file_sim=False,
                           overwrite_from_fax_file_proc=False,
                           cmt_option_overwrite_sim=None,
                           cmt_option_overwrite_proc=None,
                           _forbid_creation_of_datatypes=tuple(),
                           **kwargs):
        """Simulation context with divergent simulation/processing CMT options
        (reference: wfsim/contexts.py:76-278)."""
        import numpy as np
        st = strax.Context(
            storage=strax.DataDirectory(output_folder),
            config=dict(detector='XENONnT',
                        fax_config=fax_config,
                        check_raw_record_overlaps=True,
                        **straxen.contexts.xnt_common_config),
            **straxen.contexts.xnt_common_opts, **kwargs)
        st.register(getattr(wf_plugins, wfsim_registry))

        if cmt_run_id_sim is None and cmt_run_id_proc is None:
            raise RuntimeError('Specify at least one CMT run id')
        cmt_run_id_sim = cmt_run_id_sim or cmt_run_id_proc
        cmt_run_id_proc = cmt_run_id_proc or cmt_run_id_sim

        cmt_options_full = straxen.get_corrections.get_cmt_options(st)
        cmt_options = {key: val['strax_option']
                       for key, val in cmt_options_full.items()}

        # Simulation-side corrections pinned to cmt_run_id_sim
        st.set_config({'gain_model_mc':
                       ('cmt_run_id', cmt_run_id_sim,
                        *cmt_options['gain_model'])})
        fax_config_override_from_cmt = {}
        for fax_field, cmt_field in [('electron_lifetime_liquid',
                                      'elife'),
                                     ('drift_velocity_liquid',
                                      'electron_drift_velocity'),
                                     ('drift_time_gate',
                                      'electron_drift_time_gate')]:
            if cmt_field in cmt_options and not overwrite_from_fax_file_sim:
                fax_config_override_from_cmt[fax_field] = (
                    'cmt_run_id', cmt_run_id_sim, *cmt_options[cmt_field])
        st.set_config({'fax_config_override_from_cmt':
                       fax_config_override_from_cmt})

        # Processing side pinned to cmt_run_id_proc
        for option, value in cmt_options.items():
            if overwrite_from_fax_file_proc and option in (
                    'elife', 'electron_drift_velocity',
                    'electron_drift_time_gate'):
                continue
            st.config[option] = ('cmt_run_id', cmt_run_id_proc, *value)

        for opts, run_id in [(cmt_option_overwrite_sim, cmt_run_id_sim),
                             (cmt_option_overwrite_proc, cmt_run_id_proc)]:
            if opts:
                for option, value in opts.items():
                    st.config[option] = value
        return st

    def xenon1t_simulation(output_folder='./strax_data'):
        """(reference: wfsim/contexts.py:281-292)"""
        st = strax.Context(
            storage=strax.DataDirectory(output_folder),
            config=dict(fax_config='fax_config_1t.json',
                        detector='XENON1T',
                        check_raw_record_overlaps=False,
                        **straxen.contexts.x1t_common_config),
            **straxen.contexts.x1t_context_config)
        st.register(wf_plugins.RawRecordsFromFax1T)
        return st
