// SDRplay API v3.06 ABI subset — faithful transcription of the vendor's
// published service-API headers (the reference bundles them at
// devices/sdrplay-handler-v3/include/sdrplay_api*.h; field order, types
// and enum values must match bit-for-bit, which makes this file
// unavoidable-similarity class (b): it IS the published ABI).  Only the
// declarations the rx backend touches are carried; every struct whose
// SIZE matters (anything embedded by value) is transcribed completely.
//
// Used by runtime/native/ingest.cc (the dlopen backend); the JAX
// package's copy of this header is also read by its in-tree fake service,
// so both sides share one layout definition.
#ifndef SDRJFM_SDRPLAY_ABI_H
#define SDRJFM_SDRPLAY_ABI_H

#ifdef __cplusplus
extern "C" {
#endif

typedef void *sdrplay_HANDLE;

#define SDRJFM_SDRPLAY_API_VERSION 3.06f
#define SDRJFM_SDRPLAY_MAX_DEVICES 16
#define SDRJFM_SDRPLAY_MAX_SER_NO_LEN 64

// ---- enums (sdrplay_api.h:40-118, sdrplay_api_tuner.h:7-50,
//      sdrplay_api_control.h:5-13) --------------------------------------
typedef enum {
  sdrjfm_sdrplay_Success = 0,
  // every non-zero value is a failure; names per sdrplay_api.h:42-67
} sdrjfm_sdrplay_ErrT;

enum {
  sdrjfm_sdrplay_Update_None = 0x00000000,
  sdrjfm_sdrplay_Update_Dev_Ppm = 0x00000002,
  sdrjfm_sdrplay_Update_Tuner_Gr = 0x00008000,
  sdrjfm_sdrplay_Update_Tuner_Frf = 0x00020000,
  sdrjfm_sdrplay_Update_Ctrl_Agc = 0x01000000,
  sdrjfm_sdrplay_Update_Ctrl_OverloadMsgAck = 0x04000000,
  sdrjfm_sdrplay_Update_Ext1_None = 0x00000000,
};

enum {
  sdrjfm_sdrplay_Tuner_Neither = 0,
  sdrjfm_sdrplay_Tuner_A = 1,
  sdrjfm_sdrplay_Tuner_B = 2,
  sdrjfm_sdrplay_Tuner_Both = 3,
};

enum {
  sdrjfm_sdrplay_BW_1_536 = 1536,   // sdrplay_api_tuner.h:13
  sdrjfm_sdrplay_IF_Zero = 0,       // sdrplay_api_tuner.h:22
  sdrjfm_sdrplay_LO_Auto = 1,       // sdrplay_api_tuner.h:33
  sdrjfm_sdrplay_AGC_DISABLE = 0,   // sdrplay_api_control.h:8
  sdrjfm_sdrplay_AGC_100HZ = 1,
};

// ---- device struct (sdrplay_api.h:141-150) ---------------------------
typedef struct {
  char SerNo[SDRJFM_SDRPLAY_MAX_SER_NO_LEN];
  unsigned char hwVer;
  int tuner;        // sdrplay_api_TunerSelectT
  int rspDuoMode;   // sdrplay_api_RspDuoModeT
  double rspDuoSampleFreq;
  sdrplay_HANDLE dev;
} sdrjfm_sdrplay_DeviceT;

// ---- tuner params (sdrplay_api_tuner.h:52-93, complete) --------------
typedef struct {
  float curr;
  float max;
  float min;
} sdrjfm_sdrplay_GainValuesT;

typedef struct {
  int gRdB;                 // default 50
  unsigned char LNAstate;   // default 0
  unsigned char syncUpdate;
  int minGr;                // sdrplay_api_MinGainReductionT
  sdrjfm_sdrplay_GainValuesT gainVals;
} sdrjfm_sdrplay_GainT;

typedef struct {
  double rfHz;              // default 200e6
  unsigned char syncUpdate;
} sdrjfm_sdrplay_RfFreqT;

typedef struct {
  unsigned char dcCal;
  unsigned char speedUp;
  int trackTime;
  int refreshRateTime;
} sdrjfm_sdrplay_DcOffsetTunerT;

typedef struct {
  int bwType;               // sdrplay_api_Bw_MHzT
  int ifType;               // sdrplay_api_If_kHzT
  int loMode;               // sdrplay_api_LoModeT
  sdrjfm_sdrplay_GainT gain;
  sdrjfm_sdrplay_RfFreqT rfFreq;
  sdrjfm_sdrplay_DcOffsetTunerT dcOffsetTuner;
} sdrjfm_sdrplay_TunerParamsT;

// ---- control params (sdrplay_api_control.h:22-55, complete) ----------
typedef struct {
  unsigned char DCenable;
  unsigned char IQenable;
} sdrjfm_sdrplay_DcOffsetT;

typedef struct {
  unsigned char enable;
  unsigned char decimationFactor;
  unsigned char wideBandSignal;
} sdrjfm_sdrplay_DecimationT;

typedef struct {
  int enable;               // sdrplay_api_AgcControlT
  int setPoint_dBfs;
  unsigned short attack_ms;
  unsigned short decay_ms;
  unsigned short decay_delay_ms;
  unsigned short decay_threshold_dB;
  int syncUpdate;
} sdrjfm_sdrplay_AgcT;

typedef struct {
  sdrjfm_sdrplay_DcOffsetT dcOffset;
  sdrjfm_sdrplay_DecimationT decimation;
  sdrjfm_sdrplay_AgcT agc;
  int adsbMode;             // sdrplay_api_AdsbModeT
} sdrjfm_sdrplay_ControlParamsT;

// ---- per-model tails (sdrplay_api_rsp1a/rsp2/rspDuo/rspDx.h,
//      complete — they size RxChannelParamsT/DevParamsT) ---------------
typedef struct {
  unsigned char rfNotchEnable;
  unsigned char rfDabNotchEnable;
} sdrjfm_sdrplay_Rsp1aParamsT;

typedef struct {
  unsigned char biasTEnable;
} sdrjfm_sdrplay_Rsp1aTunerParamsT;

typedef struct {
  unsigned char extRefOutputEn;
} sdrjfm_sdrplay_Rsp2ParamsT;

typedef struct {
  unsigned char biasTEnable;
  int amPortSel;
  int antennaSel;
  unsigned char rfNotchEnable;
} sdrjfm_sdrplay_Rsp2TunerParamsT;

typedef struct {
  int extRefOutputEn;
} sdrjfm_sdrplay_RspDuoParamsT;

typedef struct {
  unsigned char biasTEnable;
  int tuner1AmPortSel;
  unsigned char tuner1AmNotchEnable;
  unsigned char rfNotchEnable;
  unsigned char rfDabNotchEnable;
} sdrjfm_sdrplay_RspDuoTunerParamsT;

typedef struct {
  unsigned char hdrEnable;
  unsigned char biasTEnable;
  int antennaSel;
  unsigned char rfNotchEnable;
  unsigned char rfDabNotchEnable;
} sdrjfm_sdrplay_RspDxParamsT;

typedef struct {
  int hdrBw;
} sdrjfm_sdrplay_RspDxTunerParamsT;

// ---- rx channel (sdrplay_api_rx_channel.h:12-21, complete) -----------
typedef struct {
  sdrjfm_sdrplay_TunerParamsT tunerParams;
  sdrjfm_sdrplay_ControlParamsT ctrlParams;
  sdrjfm_sdrplay_Rsp1aTunerParamsT rsp1aTunerParams;
  sdrjfm_sdrplay_Rsp2TunerParamsT rsp2TunerParams;
  sdrjfm_sdrplay_RspDuoTunerParamsT rspDuoTunerParams;
  sdrjfm_sdrplay_RspDxTunerParamsT rspDxTunerParams;
} sdrjfm_sdrplay_RxChannelParamsT;

// ---- dev params (sdrplay_api_dev.h:16-49, complete) ------------------
typedef struct {
  double fsHz;
  unsigned char syncUpdate;
  unsigned char reCal;
} sdrjfm_sdrplay_FsFreqT;

typedef struct {
  unsigned int sampleNum;
  unsigned int period;
} sdrjfm_sdrplay_SyncUpdateT;

typedef struct {
  unsigned char resetGainUpdate;
  unsigned char resetRfUpdate;
  unsigned char resetFsUpdate;
} sdrjfm_sdrplay_ResetFlagsT;

typedef struct {
  double ppm;
  sdrjfm_sdrplay_FsFreqT fsFreq;
  sdrjfm_sdrplay_SyncUpdateT syncUpdate;
  sdrjfm_sdrplay_ResetFlagsT resetFlags;
  int mode;                 // sdrplay_api_TransferModeT
  unsigned int samplesPerPkt;
  sdrjfm_sdrplay_Rsp1aParamsT rsp1aParams;
  sdrjfm_sdrplay_Rsp2ParamsT rsp2Params;
  sdrjfm_sdrplay_RspDuoParamsT rspDuoParams;
  sdrjfm_sdrplay_RspDxParamsT rspDxParams;
} sdrjfm_sdrplay_DevParamsT;

typedef struct {
  sdrjfm_sdrplay_DevParamsT *devParams;
  sdrjfm_sdrplay_RxChannelParamsT *rxChannelA;
  sdrjfm_sdrplay_RxChannelParamsT *rxChannelB;
} sdrjfm_sdrplay_DeviceParamsT;

// ---- callbacks (sdrplay_api_callback.h:56-77) ------------------------
typedef struct {
  unsigned int firstSampleNum;
  int grChanged;
  int rfChanged;
  int fsChanged;
  unsigned int numSamples;
} sdrjfm_sdrplay_StreamCbParamsT;

typedef void (*sdrjfm_sdrplay_StreamCallback_t)(
    short *xi, short *xq, sdrjfm_sdrplay_StreamCbParamsT *params,
    unsigned int numSamples, unsigned int reset, void *cbContext);
typedef void (*sdrjfm_sdrplay_EventCallback_t)(int eventId, int tuner,
                                               void *params,
                                               void *cbContext);

typedef struct {
  sdrjfm_sdrplay_StreamCallback_t StreamACbFn;
  sdrjfm_sdrplay_StreamCallback_t StreamBCbFn;
  sdrjfm_sdrplay_EventCallback_t EventCbFn;
} sdrjfm_sdrplay_CallbackFnsT;

#ifdef __cplusplus
}
#endif

#endif  // SDRJFM_SDRPLAY_ABI_H
